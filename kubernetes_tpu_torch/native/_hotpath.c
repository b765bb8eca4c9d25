/* Native host data plane: the hot label-selector matcher.
 *
 * SURVEY.md section 2.4: the reference has no native scheduling code (all
 * Go); the native components owed here are the NEW performance core. On
 * the host side the single hottest string operation is label-selector
 * matching -- every pack family (affinity/spread/selector-spread/
 * preferred-affinity count tensors), PDB budget filtering, the disruption
 * controller, and the affinity queue wakeups all reduce to
 * labels_match_selector() over (pod labels, selector) pairs, O(pods x
 * rows) per batch. This module implements the match against a
 * PRE-COMPILED selector form (built once per selector object by
 * kubernetes_tpu_torch/api/selectors.py):
 *
 *   compiled = (match_labels_dict,
 *               ((key, opcode, values_frozenset), ...))
 *   opcodes: 0=In 1=NotIn 2=Exists 3=DoesNotExist
 *
 * Exposed functions:
 *   match_compiled(labels_dict, compiled) -> bool
 *   match_mask(labels_list, compiled) -> bytes   (one byte per entry;
 *       the packers' inner loops over many pods per selector)
 *   dict_covers(labels_dict, selector_dict) -> bool  (plain map
 *       selectors: every kv present; empty selector -> False, matching
 *       label_selector_as_dict_matches)
 *
 * Python fallbacks with identical semantics live in api/selectors.py;
 * tests/test_native_selectors.py differentially fuzzes the two.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

static int
match_compiled_impl(PyObject *labels, PyObject *compiled)
{
    /* returns 1 match, 0 no match, -1 error */
    PyObject *ml = PyTuple_GET_ITEM(compiled, 0);   /* dict */
    PyObject *exprs = PyTuple_GET_ITEM(compiled, 1); /* tuple */

    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(ml, &pos, &key, &value)) {
        PyObject *got = PyDict_GetItemWithError(labels, key);
        if (got == NULL) {
            if (PyErr_Occurred())
                return -1;
            return 0;
        }
        int eq = PyObject_RichCompareBool(got, value, Py_EQ);
        if (eq < 0)
            return -1;
        if (!eq)
            return 0;
    }

    Py_ssize_t n = PyTuple_GET_SIZE(exprs);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *req = PyTuple_GET_ITEM(exprs, i);
        PyObject *rkey = PyTuple_GET_ITEM(req, 0);
        long op = PyLong_AsLong(PyTuple_GET_ITEM(req, 1));
        PyObject *values = PyTuple_GET_ITEM(req, 2);
        PyObject *got = PyDict_GetItemWithError(labels, rkey);
        if (got == NULL && PyErr_Occurred())
            return -1;
        int ok;
        switch (op) {
        case 0: /* In */
            if (got == NULL) {
                ok = 0;
            } else {
                ok = PySet_Contains(values, got);
                if (ok < 0)
                    return -1;
            }
            break;
        case 1: /* NotIn */
            if (got == NULL) {
                ok = 1;
            } else {
                int in = PySet_Contains(values, got);
                if (in < 0)
                    return -1;
                ok = !in;
            }
            break;
        case 2: /* Exists */
            ok = got != NULL;
            break;
        case 3: /* DoesNotExist */
            ok = got == NULL;
            break;
        default:
            /* opcode -1: an operator the compiler didn't recognize;
             * raised only when evaluation reaches it, matching the
             * Python path's short-circuit semantics */
            PyErr_SetString(PyExc_ValueError,
                            "unknown label selector operator");
            return -1;
        }
        if (!ok)
            return 0;
    }
    return 1;
}

static PyObject *
match_compiled(PyObject *self, PyObject *args)
{
    PyObject *labels, *compiled;
    if (!PyArg_ParseTuple(args, "O!O!", &PyDict_Type, &labels,
                          &PyTuple_Type, &compiled))
        return NULL;
    int r = match_compiled_impl(labels, compiled);
    if (r < 0)
        return NULL;
    if (r)
        Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static PyObject *
match_mask(PyObject *self, PyObject *args)
{
    PyObject *labels_list, *compiled;
    if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &labels_list,
                          &PyTuple_Type, &compiled))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(labels_list);
    PyObject *out = PyBytes_FromStringAndSize(NULL, n);
    if (out == NULL)
        return NULL;
    char *buf = PyBytes_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *labels = PyList_GET_ITEM(labels_list, i);
        if (!PyDict_Check(labels)) {
            Py_DECREF(out);
            PyErr_SetString(PyExc_TypeError, "labels entries must be dicts");
            return NULL;
        }
        int r = match_compiled_impl(labels, compiled);
        if (r < 0) {
            Py_DECREF(out);
            return NULL;
        }
        buf[i] = (char)r;
    }
    return out;
}

static PyObject *
dict_covers(PyObject *self, PyObject *args)
{
    PyObject *labels, *selector;
    if (!PyArg_ParseTuple(args, "O!O!", &PyDict_Type, &labels,
                          &PyDict_Type, &selector))
        return NULL;
    if (PyDict_GET_SIZE(selector) == 0)
        Py_RETURN_FALSE; /* empty map selector matches nothing */
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(selector, &pos, &key, &value)) {
        PyObject *got = PyDict_GetItemWithError(labels, key);
        if (got == NULL) {
            if (PyErr_Occurred())
                return NULL;
            Py_RETURN_FALSE;
        }
        int eq = PyObject_RichCompareBool(got, value, Py_EQ);
        if (eq < 0)
            return NULL;
        if (!eq)
            Py_RETURN_FALSE;
    }
    Py_RETURN_TRUE;
}

/* -- copy-on-write object clones (the commit-path hot loop) -------------
 *
 * The bulk bind/assume pipeline clones every pod 2-4 times per commit
 * (assumed_clone: pod+spec; _bind_locked: pod+metadata+spec+status).
 * copy.copy() routes each clone through __reduce_ex__/_reconstruct at
 * ~5-7us a call; at 10k pods x 6 clones that is ~0.4s of the measured
 * burst window. cow_clone() does the same thing the direct way: allocate
 * via the type (no __init__), dict-copy __dict__, and shallow-clone the
 * named nested attributes in the same call. Reference analogue: the Go
 * scheduler's pod.DeepCopy() before assume (scheduler.go:474) -- ours is
 * shallow because downstream only writes spec.node_name /
 * metadata.resource_version (the informer-cache read-only contract).
 */

static PyObject *str_dict = NULL; /* interned "__dict__" */

static PyObject *
shallow_clone_one(PyObject *obj)
{
    PyTypeObject *tp = Py_TYPE(obj);
    PyObject *new = tp->tp_alloc(tp, 0);
    if (new == NULL)
        return NULL;
    PyObject *d = PyObject_GetAttr(obj, str_dict);
    if (d == NULL) {
        Py_DECREF(new);
        return NULL;
    }
    PyObject *dc = PyDict_Copy(d);
    Py_DECREF(d);
    if (dc == NULL) {
        Py_DECREF(new);
        return NULL;
    }
    if (PyObject_SetAttr(new, str_dict, dc) < 0) {
        Py_DECREF(dc);
        Py_DECREF(new);
        return NULL;
    }
    Py_DECREF(dc);
    return new;
}

static PyObject *
cow_clone(PyObject *self, PyObject *args)
{
    /* cow_clone(obj, ("spec", "status", ...)) -> clone
     * Shallow-clones obj, then shallow-clones each named attribute on
     * the clone so the caller may mutate those sub-objects freely. */
    PyObject *obj, *attrs;
    if (!PyArg_ParseTuple(args, "OO!", &obj, &PyTuple_Type, &attrs))
        return NULL;
    PyObject *new = shallow_clone_one(obj);
    if (new == NULL)
        return NULL;
    Py_ssize_t n = PyTuple_GET_SIZE(attrs);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *name = PyTuple_GET_ITEM(attrs, i);
        PyObject *sub = PyObject_GetAttr(obj, name);
        if (sub == NULL)
            goto fail;
        PyObject *subc = shallow_clone_one(sub);
        Py_DECREF(sub);
        if (subc == NULL)
            goto fail;
        int r = PyObject_SetAttr(new, name, subc);
        Py_DECREF(subc);
        if (r < 0)
            goto fail;
    }
    return new;
fail:
    Py_DECREF(new);
    return NULL;
}

/* -- bulk commit spine ---------------------------------------------------
 *
 * The 10k-burst commit window spends most of its host budget in two
 * per-pod loops: (a) assumed_clone + spec.node_name per committed pod
 * (batch.py commit.clone) and (b) the apiserver bind transaction
 * (server.py bind_bulk: lookup, uid/bound checks, cow clone, rv bump,
 * store write, watch-event build). Both are pure object-graph work with
 * no Python-level semantics beyond dict/attr ops, so they live here as
 * single C loops: assume_clones() and bind_assumed_bulk(). The Python
 * fallbacks (api/types.py assumed_clone, server.py _bind_locked) carry
 * the same semantics; tests/test_native_commit.py differentially
 * exercises native vs fallback on the same inputs.
 */

static PyObject *str_spec = NULL;
static PyObject *str_node_name = NULL;
static PyObject *str_metadata = NULL;
static PyObject *str_namespace = NULL;
static PyObject *str_name = NULL;
static PyObject *str_uid = NULL;
static PyObject *str_resource_version = NULL;
static PyObject *str_sig_memo = NULL;
static PyObject *str_modified = NULL;

/* Install dict `dc` (reference stolen) as `obj`'s instance dict via the
 * dict pointer when the layout allows it, else through the __dict__
 * descriptor. Returns 0 ok / -1 error (dc released either way). */
static int
install_dict(PyObject *obj, PyObject *dc)
{
    PyObject **dp = _PyObject_GetDictPtr(obj);
    if (dp != NULL) {
        Py_XSETREF(*dp, dc);
        return 0;
    }
    int r = PyObject_SetAttr(obj, str_dict, dc);
    Py_DECREF(dc);
    return r;
}

/* Shallow-clone obj by dict copy; optionally override one key in (and/or
 * drop one key from) the copied dict before installing it. */
static PyObject *
clone_with_dict(PyObject *obj, PyObject *override_key, PyObject *override_val,
                PyObject *drop_key)
{
    PyTypeObject *tp = Py_TYPE(obj);
    PyObject *new = tp->tp_alloc(tp, 0);
    if (new == NULL)
        return NULL;
    PyObject *d = PyObject_GetAttr(obj, str_dict);
    if (d == NULL) {
        Py_DECREF(new);
        return NULL;
    }
    PyObject *dc = PyDict_Copy(d);
    Py_DECREF(d);
    if (dc == NULL) {
        Py_DECREF(new);
        return NULL;
    }
    if (override_key != NULL &&
        PyDict_SetItem(dc, override_key, override_val) < 0) {
        Py_DECREF(dc);
        Py_DECREF(new);
        return NULL;
    }
    if (drop_key != NULL && PyDict_Contains(dc, drop_key) == 1 &&
        PyDict_DelItem(dc, drop_key) < 0) {
        Py_DECREF(dc);
        Py_DECREF(new);
        return NULL;
    }
    if (install_dict(new, dc) < 0) {
        Py_DECREF(new);
        return NULL;
    }
    return new;
}

static PyObject *
assume_clones(PyObject *self, PyObject *args)
{
    /* assume_clones(pods, hosts) -> [clone] where clone = shallow pod
     * with shallow spec and spec.node_name = host (the one-call form of
     * Pod.assumed_clone() + node_name assignment per committed pod). */
    PyObject *pods, *hosts;
    if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &pods,
                          &PyList_Type, &hosts))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(pods);
    if (PyList_GET_SIZE(hosts) != n) {
        PyErr_SetString(PyExc_ValueError, "pods/hosts length mismatch");
        return NULL;
    }
    PyObject *out = PyList_New(n);
    if (out == NULL)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *pod = PyList_GET_ITEM(pods, i);
        PyObject *host = PyList_GET_ITEM(hosts, i);
        PyObject *spec = PyObject_GetAttr(pod, str_spec);
        if (spec == NULL)
            goto fail;
        PyObject *specc = clone_with_dict(spec, str_node_name, host, NULL);
        Py_DECREF(spec);
        if (specc == NULL)
            goto fail;
        PyObject *podc = clone_with_dict(pod, str_spec, specc, NULL);
        Py_DECREF(specc);
        if (podc == NULL)
            goto fail;
        PyList_SET_ITEM(out, i, podc);
    }
    return out;
fail:
    Py_DECREF(out);
    return NULL;
}

static PyObject *str_pod = NULL;

static PyObject *
commit_gather(PyObject *self, PyObject *args)
{
    /* commit_gather(solver_infos, order, assignments, names)
     *   -> (pod_infos, clones, hosts)
     *
     * One C pass over a solved batch's PLACED slots (the committer
     * splits NO_NODE slots off with numpy before calling): slot j
     * gathers pod_info = solver_infos[order[j]], resolves
     * host = names[assignments[j]], and builds the assumed clone
     * (shallow pod + shallow spec with spec.node_name = host) in the
     * same step -- fusing the commit loop's gather with the
     * assume_clones pass so the per-pod Python work of the bulk commit
     * is three parallel C-built lists. order/assignments are plain int
     * lists (numpy .tolist() output); semantics match the Python
     * fallback in scheduler/batch.py (_commit_gather_py),
     * differentially tested in tests/test_native_commit.py. */
    PyObject *infos, *order, *assigns, *names;
    if (!PyArg_ParseTuple(args, "O!O!O!O!", &PyList_Type, &infos,
                          &PyList_Type, &order, &PyList_Type, &assigns,
                          &PyList_Type, &names))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(order);
    if (PyList_GET_SIZE(assigns) != n) {
        PyErr_SetString(PyExc_ValueError, "order/assignments length mismatch");
        return NULL;
    }
    Py_ssize_t n_infos = PyList_GET_SIZE(infos);
    Py_ssize_t n_names = PyList_GET_SIZE(names);
    PyObject *pis = PyList_New(n);
    PyObject *clones = PyList_New(n);
    PyObject *hosts = PyList_New(n);
    if (pis == NULL || clones == NULL || hosts == NULL)
        goto fail;
    for (Py_ssize_t j = 0; j < n; j++) {
        long oi = PyLong_AsLong(PyList_GET_ITEM(order, j));
        long ci = PyLong_AsLong(PyList_GET_ITEM(assigns, j));
        if ((oi == -1 || ci == -1) && PyErr_Occurred())
            goto fail;
        if (oi < 0 || oi >= n_infos || ci < 0 || ci >= n_names) {
            PyErr_SetString(PyExc_IndexError,
                            "commit_gather index out of range");
            goto fail;
        }
        PyObject *pi = PyList_GET_ITEM(infos, oi);
        PyObject *host = PyList_GET_ITEM(names, ci);
        PyObject *pod = PyObject_GetAttr(pi, str_pod);
        if (pod == NULL)
            goto fail;
        PyObject *spec = PyObject_GetAttr(pod, str_spec);
        if (spec == NULL) {
            Py_DECREF(pod);
            goto fail;
        }
        PyObject *specc = clone_with_dict(spec, str_node_name, host, NULL);
        Py_DECREF(spec);
        if (specc == NULL) {
            Py_DECREF(pod);
            goto fail;
        }
        PyObject *podc = clone_with_dict(pod, str_spec, specc, NULL);
        Py_DECREF(specc);
        Py_DECREF(pod);
        if (podc == NULL)
            goto fail;
        Py_INCREF(pi);
        PyList_SET_ITEM(pis, j, pi);
        PyList_SET_ITEM(clones, j, podc);
        Py_INCREF(host);
        PyList_SET_ITEM(hosts, j, host);
    }
    return Py_BuildValue("(NNN)", pis, clones, hosts);
fail:
    Py_XDECREF(pis);
    Py_XDECREF(clones);
    Py_XDECREF(hosts);
    return NULL;
}

static PyObject *
bind_assumed_bulk(PyObject *self, PyObject *args)
{
    /* bind_assumed_bulk(store, assumed_list, rv, event_cls)
     *   -> (errors, events, new_rv)
     *
     * One C pass over the whole bulk-bind transaction (caller holds the
     * store lock). Per slot, semantics match server._bind_locked: lookup
     * by (namespace, name), uid check, already-bound check, target
     * check, copy-on-write clone of the STORED pod (metadata+spec;
     * status stays shared -- see inline note) with spec.node_name set,
     * _sig_memo dropped, resource_version assigned sequentially from
     * rv+1. errors = [(index, code, msg)] with code 0=NotFound
     * 1=Conflict 2=ValueError 3=internal; events = [event_cls(MODIFIED,
     * pod, rv)] for the successes, in store order. Per-slot failures
     * (including unexpected ones) never abort the slots already
     * committed. Differential parity with the Python fallback:
     * tests/test_native_commit.py. */
    PyObject *store, *assumed_list, *event_cls;
    long rv;
    if (!PyArg_ParseTuple(args, "O!O!lO", &PyDict_Type, &store,
                          &PyList_Type, &assumed_list, &rv, &event_cls))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(assumed_list);
    PyObject *errors = PyList_New(0);
    PyObject *events = PyList_New(0);
    if (errors == NULL || events == NULL) {
        Py_XDECREF(errors);
        Py_XDECREF(events);
        return NULL;
    }

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *assumed = PyList_GET_ITEM(assumed_list, i);
        PyObject *meta = NULL, *ns = NULL, *name = NULL, *uid = NULL;
        PyObject *spec = NULL, *target = NULL, *key = NULL;
        int errcode = -1;
        int rv_bumped = 0;
        const char *errfmt = NULL;

        meta = PyObject_GetAttr(assumed, str_metadata);
        if (meta == NULL)
            goto hard_fail;
        ns = PyObject_GetAttr(meta, str_namespace);
        name = PyObject_GetAttr(meta, str_name);
        uid = PyObject_GetAttr(meta, str_uid);
        Py_DECREF(meta);
        if (ns == NULL || name == NULL || uid == NULL)
            goto hard_fail;
        spec = PyObject_GetAttr(assumed, str_spec);
        if (spec == NULL)
            goto hard_fail;
        target = PyObject_GetAttr(spec, str_node_name);
        Py_DECREF(spec);
        if (target == NULL)
            goto hard_fail;

        key = PyTuple_Pack(2, ns, name);
        if (key == NULL)
            goto hard_fail;
        PyObject *old = PyDict_GetItemWithError(store, key); /* borrowed */
        if (old == NULL) {
            if (PyErr_Occurred())
                goto hard_fail;
            errcode = 0;
            errfmt = "Pod %U/%U not found";
            goto slot_error;
        }

        PyObject *old_meta = PyObject_GetAttr(old, str_metadata);
        if (old_meta == NULL)
            goto hard_fail;
        PyObject *old_uid = PyObject_GetAttr(old_meta, str_uid);
        if (old_uid == NULL) {
            Py_DECREF(old_meta);
            goto hard_fail;
        }
        int uid_true = PyObject_IsTrue(uid);
        if (uid_true > 0) {
            int eq = PyObject_RichCompareBool(old_uid, uid, Py_EQ);
            if (eq < 0) {
                Py_DECREF(old_uid);
                Py_DECREF(old_meta);
                goto hard_fail;
            }
            if (!eq) {
                Py_DECREF(old_uid);
                Py_DECREF(old_meta);
                errcode = 1;
                errfmt = "pod %U/%U uid mismatch";
                goto slot_error;
            }
        } else if (uid_true < 0) {
            Py_DECREF(old_uid);
            Py_DECREF(old_meta);
            goto hard_fail;
        }
        Py_DECREF(old_uid);

        PyObject *old_spec = PyObject_GetAttr(old, str_spec);
        if (old_spec == NULL) {
            Py_DECREF(old_meta);
            goto hard_fail;
        }
        PyObject *old_nn = PyObject_GetAttr(old_spec, str_node_name);
        if (old_nn == NULL) {
            Py_DECREF(old_spec);
            Py_DECREF(old_meta);
            goto hard_fail;
        }
        int bound = PyObject_IsTrue(old_nn);
        if (bound > 0) {
            int same = PyObject_RichCompareBool(old_nn, target, Py_EQ);
            if (same < 0) {
                Py_DECREF(old_nn);
                Py_DECREF(old_spec);
                Py_DECREF(old_meta);
                goto hard_fail;
            }
            if (!same) {
                Py_DECREF(old_nn);
                Py_DECREF(old_spec);
                Py_DECREF(old_meta);
                errcode = 1;
                errfmt = "pod %U/%U is already bound";
                goto slot_error;
            }
            /* already bound to the SAME node: idempotent success (a
             * retried commit whose first attempt landed, or a restarted
             * scheduler re-driving a recovered placement) -- the store
             * already holds exactly the requested state, so no write,
             * no rv bump, no event (parity: _bind_locked changed=False) */
            Py_DECREF(old_nn);
            Py_DECREF(old_spec);
            Py_DECREF(old_meta);
            Py_DECREF(key);
            Py_DECREF(ns);
            Py_DECREF(name);
            Py_DECREF(uid);
            Py_DECREF(target);
            continue;
        } else if (bound < 0) {
            Py_DECREF(old_nn);
            Py_DECREF(old_spec);
            Py_DECREF(old_meta);
            goto hard_fail;
        }
        Py_DECREF(old_nn);

        /* target required -- checked LAST, matching _bind_locked's
         * check order (uid, already-bound, then target) */
        int target_true = PyObject_IsTrue(target);
        if (target_true < 0) {
            Py_DECREF(old_spec);
            Py_DECREF(old_meta);
            goto hard_fail;
        }
        if (!target_true) {
            Py_DECREF(old_spec);
            Py_DECREF(old_meta);
            errcode = 2;
            errfmt = "binding for %U/%U has no target node";
            goto slot_error;
        }

        /* success: COW clone of the stored pod */
        rv += 1;
        rv_bumped = 1;
        PyObject *rv_obj = PyLong_FromLong(rv);
        if (rv_obj == NULL) {
            Py_DECREF(old_spec);
            Py_DECREF(old_meta);
            goto hard_fail;
        }
        /* status stays SHARED between old and new: every status write
         * goes through guaranteed_update/update_pod_status, which clone
         * status themselves before mutating (the informer read-only
         * contract makes the shared reference safe). */
        PyObject *metac =
            clone_with_dict(old_meta, str_resource_version, rv_obj, NULL);
        Py_DECREF(old_meta);
        PyObject *specc =
            clone_with_dict(old_spec, str_node_name, target, NULL);
        Py_DECREF(old_spec);
        if (metac == NULL || specc == NULL) {
            Py_XDECREF(metac);
            Py_XDECREF(specc);
            Py_DECREF(rv_obj);
            goto hard_fail;
        }

        PyTypeObject *tp = Py_TYPE(old);
        PyObject *podc = tp->tp_alloc(tp, 0);
        PyObject *d = podc ? PyObject_GetAttr(old, str_dict) : NULL;
        PyObject *dc = d ? PyDict_Copy(d) : NULL;
        Py_XDECREF(d);
        int ok = podc != NULL && dc != NULL &&
                 PyDict_SetItem(dc, str_metadata, metac) == 0 &&
                 PyDict_SetItem(dc, str_spec, specc) == 0;
        if (ok && PyDict_Contains(dc, str_sig_memo) == 1)
            ok = PyDict_DelItem(dc, str_sig_memo) == 0;
        if (ok) {
            ok = install_dict(podc, dc) == 0;
            dc = NULL; /* reference consumed by install_dict */
        }
        Py_XDECREF(dc);
        Py_DECREF(metac);
        Py_DECREF(specc);
        if (!ok) {
            Py_XDECREF(podc);
            Py_DECREF(rv_obj);
            goto hard_fail;
        }
        /* event BEFORE the store write: a failure here leaves the slot
         * (and the store) untouched, so the transaction stays
         * event-consistent per slot */
        PyObject *event = PyObject_CallFunctionObjArgs(
            event_cls, str_modified, podc, rv_obj, NULL);
        Py_DECREF(rv_obj);
        if (event == NULL) {
            Py_DECREF(podc);
            goto hard_fail;
        }
        Py_INCREF(old); /* keep alive across the store replace for rollback */
        if (PyDict_SetItem(store, key, podc) < 0) {
            Py_DECREF(old);
            Py_DECREF(podc);
            Py_DECREF(event);
            goto hard_fail;
        }
        int ap = PyList_Append(events, event);
        Py_DECREF(event);
        if (ap < 0) {
            /* roll the slot back so store and events stay consistent */
            if (PyDict_SetItem(store, key, old) < 0)
                PyErr_Clear();
            Py_DECREF(old);
            Py_DECREF(podc);
            goto hard_fail;
        }
        Py_DECREF(old);
        Py_DECREF(podc);
        Py_DECREF(key);
        Py_DECREF(ns);
        Py_DECREF(name);
        Py_DECREF(uid);
        Py_DECREF(target);
        continue;

    slot_error: {
        PyObject *msg = PyUnicode_FromFormat(errfmt, ns, name);
        PyObject *slot =
            msg ? Py_BuildValue("(niN)", i, errcode, msg) : NULL;
        Py_XDECREF(key);
        Py_DECREF(ns);
        Py_DECREF(name);
        Py_DECREF(uid);
        Py_DECREF(target);
        if (slot == NULL)
            goto abort_fail;
        int ap = PyList_Append(errors, slot);
        Py_DECREF(slot);
        if (ap < 0)
            goto abort_fail;
        continue;
    }

    hard_fail: {
        /* An unexpected per-slot failure (allocation, broken attribute)
         * must NOT abort the transaction: earlier slots already mutated
         * the store and their watch events/rv advance must still reach
         * the caller. Convert to a slot error (code 3) and continue;
         * the failed slot itself left the store untouched -- including
         * its provisional rv, matching the Python path where _next_rv
         * only runs after validation. */
        if (rv_bumped)
            rv -= 1;
        Py_XDECREF(key);
        Py_XDECREF(ns);
        Py_XDECREF(name);
        Py_XDECREF(uid);
        Py_XDECREF(target);
        PyObject *et = NULL, *ev = NULL, *tb = NULL;
        PyErr_Fetch(&et, &ev, &tb);
        PyObject *msg = NULL;
        if (ev != NULL)
            msg = PyObject_Str(ev);
        else if (et != NULL)
            msg = PyObject_Str(et);
        else
            msg = PyUnicode_FromString("internal bind error");
        Py_XDECREF(et);
        Py_XDECREF(ev);
        Py_XDECREF(tb);
        if (msg == NULL)
            goto abort_fail;
        PyObject *slot = Py_BuildValue("(niN)", i, 3, msg);
        if (slot == NULL)
            goto abort_fail;
        int ap = PyList_Append(errors, slot);
        Py_DECREF(slot);
        if (ap < 0)
            goto abort_fail;
        continue;
    }

    abort_fail:
        /* only reachable when even recording the error fails (OOM on
         * OOM); nothing sensible left to report */
        PyErr_Clear();
        PyErr_SetString(PyExc_MemoryError,
                        "bind_assumed_bulk: cannot record slot error");
        Py_DECREF(errors);
        Py_DECREF(events);
        return NULL;
    }
    return Py_BuildValue("(NNl)", errors, events, rv);
}

/* -- ingest spine --------------------------------------------------------
 *
 * The host-side control-plane FRONT END (watch frame -> informer store ->
 * admission memo -> queue entry -> pack row) walked Python objects per
 * event per informer set and per pod per pack cycle; after the device-
 * side delta/carry work the solver outran its input (ROADMAP item 5).
 * These loops move that walking into C, in three layers:
 *
 *   ingest_decode / ingest_apply -- watch frames are decoded ONCE per
 *     apiserver transaction into an immutable (namespace, name) key
 *     record memoized on the WatchEvent (`decoded` slot); every informer
 *     cursor (N partitioned stacks share the per-kind event log) applies
 *     the frame to its store and builds the handler dispatch list in one
 *     C pass over those shared records.
 *
 *   ingest_stamp -- the admission classifier's fast path: a PLAIN pod
 *     (no volumes, no affinity, no spread, no NUMA annotation, no gang
 *     label, no host ports, no unresolved priority class) gets its
 *     entire ingest record built in one C pass: _req_memo, _nzr_memo,
 *     _hot_memo, the pack-ready _packrow, _band_priority, and the
 *     SHARED plain Admission record. Non-plain pods are returned by
 *     index for the full Python classifier.
 *
 *   pack_gather -- pack_pod_batch's per-pod-per-cycle spec walk becomes
 *     a C gather over the _packrow memos into preallocated int32
 *     buffers, deduping request rows through a caller-owned dict (only
 *     DISTINCT rows go back to Python for schema encoding).
 *
 *   queue_shape -- the bulk apiserver->queue path: one C pass over a
 *     create burst's pods producing (keys, priorities, nominations) so
 *     PriorityQueue.add_many builds its heap entries without per-pod
 *     attribute walks.
 *
 * Pure-Python twins with identical semantics live next to each call
 * site (client/informer.py, scheduler/admission.py,
 * tensors/node_tensor.py, queue/scheduling_queue.py), selected by
 * KTPU_NATIVE_INGEST=0; tests/test_native_ingest.py differentially
 * fuzzes the two.
 */

static PyObject *str_obj_attr = NULL;      /* "object" */
static PyObject *str_type_attr = NULL;     /* "type" */
static PyObject *str_decoded = NULL;
static PyObject *str_added = NULL;         /* "ADDED" */
static PyObject *str_deleted = NULL;       /* "DELETED" */
static PyObject *str_status = NULL;
static PyObject *str_nominated = NULL;     /* "nominated_node_name" */
static PyObject *str_priority = NULL;
static PyObject *str_priority_class = NULL;
static PyObject *str_annotations = NULL;
static PyObject *str_labels = NULL;
static PyObject *str_volumes = NULL;
static PyObject *str_affinity = NULL;
static PyObject *str_spread = NULL;        /* "topology_spread_constraints" */
static PyObject *str_containers = NULL;
static PyObject *str_init_containers = NULL;
static PyObject *str_overhead = NULL;
static PyObject *str_resources = NULL;
static PyObject *str_requests = NULL;
static PyObject *str_ports = NULL;
static PyObject *str_host_port = NULL;
static PyObject *str_packrow = NULL;       /* "_packrow" */
static PyObject *str_band_priority = NULL; /* "_band_priority" */
static PyObject *str_admission = NULL;     /* "_admission" */
static PyObject *str_req_memo = NULL;
static PyObject *str_nzr_memo = NULL;
static PyObject *str_hot_memo = NULL;

/* Decode one WatchEvent into its shared (namespace, name) key record,
 * memoized on ev.decoded. Returns a NEW reference. */
static PyObject *
decode_event_key(PyObject *ev)
{
    PyObject *dec = PyObject_GetAttr(ev, str_decoded);
    if (dec == NULL)
        return NULL;
    if (dec != Py_None)
        return dec;
    Py_DECREF(dec);
    PyObject *obj = PyObject_GetAttr(ev, str_obj_attr);
    if (obj == NULL)
        return NULL;
    PyObject *meta = PyObject_GetAttr(obj, str_metadata);
    Py_DECREF(obj);
    if (meta == NULL)
        return NULL;
    PyObject *ns = PyObject_GetAttr(meta, str_namespace);
    PyObject *name = PyObject_GetAttr(meta, str_name);
    Py_DECREF(meta);
    if (ns == NULL || name == NULL) {
        Py_XDECREF(ns);
        Py_XDECREF(name);
        return NULL;
    }
    PyObject *key = PyTuple_Pack(2, ns, name);
    Py_DECREF(ns);
    Py_DECREF(name);
    if (key == NULL)
        return NULL;
    if (PyObject_SetAttr(ev, str_decoded, key) < 0) {
        Py_DECREF(key);
        return NULL;
    }
    return key;
}

static PyObject *
ingest_decode(PyObject *self, PyObject *args)
{
    /* ingest_decode(events) -> [key]: decode (and memoize) every
     * event's key record in one pass; later consumers -- including
     * sibling informer sets draining the same shared log -- read the
     * memo instead of re-walking obj.metadata. */
    PyObject *events;
    if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &events))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(events);
    PyObject *out = PyList_New(n);
    if (out == NULL)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *key = decode_event_key(PyList_GET_ITEM(events, i));
        if (key == NULL) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, i, key);
    }
    return out;
}

static int
ev_type_is(PyObject *t, PyObject *interned)
{
    /* identity first (the constants flow from one module), value
     * compare as the fallback; -1 on error */
    if (t == interned)
        return 1;
    return PyObject_RichCompareBool(t, interned, Py_EQ);
}

static PyObject *
ingest_apply(PyObject *self, PyObject *args)
{
    /* ingest_apply(store, events) -> [(etype, old, new)]
     *
     * The informer's per-frame store update + dispatch build in one C
     * pass (semantics: client/informer.py _apply_batch_py, the
     * differential twin). Caller holds the informer store lock. Events
     * with an unknown type are skipped, matching the Python branch
     * structure. */
    PyObject *store, *events;
    if (!PyArg_ParseTuple(args, "O!O!", &PyDict_Type, &store,
                          &PyList_Type, &events))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(events);
    PyObject *dispatch = PyList_New(0);
    if (dispatch == NULL)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *ev = PyList_GET_ITEM(events, i);
        PyObject *key = decode_event_key(ev);
        if (key == NULL)
            goto fail;
        PyObject *obj = PyObject_GetAttr(ev, str_obj_attr);
        PyObject *t = obj ? PyObject_GetAttr(ev, str_type_attr) : NULL;
        if (obj == NULL || t == NULL) {
            Py_XDECREF(obj);
            Py_XDECREF(t);
            Py_DECREF(key);
            goto fail;
        }
        PyObject *slot = NULL;
        int r = ev_type_is(t, str_added);
        if (r < 0)
            goto ev_fail;
        if (r) {
            if (PyDict_SetItem(store, key, obj) < 0)
                goto ev_fail;
            slot = PyTuple_Pack(3, t, Py_None, obj);
        } else if ((r = ev_type_is(t, str_modified)) != 0) {
            if (r < 0)
                goto ev_fail;
            PyObject *old = PyDict_GetItemWithError(store, key);
            if (old == NULL && PyErr_Occurred())
                goto ev_fail;
            Py_XINCREF(old);
            if (PyDict_SetItem(store, key, obj) < 0) {
                Py_XDECREF(old);
                goto ev_fail;
            }
            slot = PyTuple_Pack(3, t, old ? old : Py_None, obj);
            Py_XDECREF(old);
        } else if ((r = ev_type_is(t, str_deleted)) != 0) {
            if (r < 0)
                goto ev_fail;
            PyObject *old = PyDict_GetItemWithError(store, key);
            if (old == NULL && PyErr_Occurred())
                goto ev_fail;
            if (old != NULL && PyDict_DelItem(store, key) < 0)
                goto ev_fail;
            slot = PyTuple_Pack(3, t, Py_None, obj);
        } else {
            /* unknown event type: no dispatch, no store change */
            Py_DECREF(obj);
            Py_DECREF(t);
            Py_DECREF(key);
            continue;
        }
        Py_DECREF(obj);
        Py_DECREF(t);
        Py_DECREF(key);
        if (slot == NULL)
            goto fail;
        if (PyList_Append(dispatch, slot) < 0) {
            Py_DECREF(slot);
            goto fail;
        }
        Py_DECREF(slot);
        continue;
    ev_fail:
        Py_DECREF(obj);
        Py_DECREF(t);
        Py_DECREF(key);
        goto fail;
    }
    return dispatch;
fail:
    Py_DECREF(dispatch);
    return NULL;
}

/* ceil-divide a nonnegative byte count to KiB (tensors _kib_ceil) */
static long long
kib_ceil_ll(long long b)
{
    return (b + 1023) / 1024;
}

/* Build the plain pod's ingest record. Returns 1 stamped, 0 not-plain
 * (caller routes to the Python classifier), -1 error. cfg layout (built
 * once by scheduler/batch.py):
 *   (plain_admission, aligned_key, group_label,
 *    cpu_name, mem_name, eph_name, pods_name,
 *    default_cpu, default_mem) */
static int
stamp_one(PyObject *pod, PyObject **cfg, long long default_cpu,
          long long default_mem)
{
    PyObject *spec = NULL, *meta = NULL, *req = NULL;
    PyObject *containers = NULL, *inits = NULL, *overhead = NULL;
    PyObject *prio = NULL;
    long long nzr_cpu = 0, nzr_mem = 0;
    int plain = 0;

    spec = PyObject_GetAttr(pod, str_spec);
    meta = PyObject_GetAttr(pod, str_metadata);
    if (spec == NULL || meta == NULL)
        goto error;

    /* -- plainness gate (mirror admission._is_plain_pod) ------------- */
    {
        PyObject *ann = PyObject_GetAttr(meta, str_annotations);
        if (ann == NULL)
            goto error;
        if (!PyDict_Check(ann)) {
            Py_DECREF(ann);
            goto not_plain;
        }
        PyObject *got = PyDict_GetItemWithError(ann, cfg[1]);
        Py_DECREF(ann);
        if (got != NULL)
            goto not_plain;
        if (PyErr_Occurred())
            goto error;
    }
    {
        PyObject *labels = PyObject_GetAttr(meta, str_labels);
        if (labels == NULL)
            goto error;
        if (!PyDict_Check(labels)) {
            Py_DECREF(labels);
            goto not_plain;
        }
        PyObject *got = PyDict_GetItemWithError(labels, cfg[2]);
        Py_DECREF(labels);
        if (got != NULL)
            goto not_plain;
        if (PyErr_Occurred())
            goto error;
    }
    {
        PyObject *v = PyObject_GetAttr(spec, str_volumes);
        if (v == NULL)
            goto error;
        int truth = PyObject_IsTrue(v);
        Py_DECREF(v);
        if (truth != 0)
            goto not_plain; /* has volumes, or error (route to Python) */
        v = PyObject_GetAttr(spec, str_affinity);
        if (v == NULL)
            goto error;
        int none = (v == Py_None);
        Py_DECREF(v);
        if (!none)
            goto not_plain;
        v = PyObject_GetAttr(spec, str_spread);
        if (v == NULL)
            goto error;
        truth = PyObject_IsTrue(v);
        Py_DECREF(v);
        if (truth != 0)
            goto not_plain;
    }
    prio = PyObject_GetAttr(spec, str_priority);
    if (prio == NULL)
        goto error;
    if (!PyLong_Check(prio))
        goto not_plain;
    {
        int prio_true = PyObject_IsTrue(prio);
        if (prio_true < 0)
            goto error;
        if (!prio_true) {
            /* bare priorityClassName needs the lister resolver */
            PyObject *pcn = PyObject_GetAttr(spec, str_priority_class);
            if (pcn == NULL)
                goto error;
            int has_pcn = PyObject_IsTrue(pcn);
            Py_DECREF(pcn);
            if (has_pcn != 0)
                goto not_plain;
        }
    }

    /* -- request walk (pod_resource_requests + non_zero_requests) ---- */
    containers = PyObject_GetAttr(spec, str_containers);
    inits = PyObject_GetAttr(spec, str_init_containers);
    overhead = PyObject_GetAttr(spec, str_overhead);
    if (containers == NULL || inits == NULL || overhead == NULL)
        goto error;
    if (!PyList_Check(containers) || !PyList_Check(inits) ||
        !PyDict_Check(overhead))
        goto not_plain;
    req = PyDict_New();
    if (req == NULL)
        goto error;
    for (Py_ssize_t c = 0; c < PyList_GET_SIZE(containers); c++) {
        PyObject *cont = PyList_GET_ITEM(containers, c);
        PyObject *ports = PyObject_GetAttr(cont, str_ports);
        if (ports == NULL)
            goto error;
        if (!PyList_Check(ports)) {
            Py_DECREF(ports);
            goto not_plain;
        }
        for (Py_ssize_t p = 0; p < PyList_GET_SIZE(ports); p++) {
            PyObject *hp =
                PyObject_GetAttr(PyList_GET_ITEM(ports, p), str_host_port);
            if (hp == NULL) {
                Py_DECREF(ports);
                goto error;
            }
            int truth = PyObject_IsTrue(hp);
            Py_DECREF(hp);
            if (truth != 0) {
                Py_DECREF(ports);
                goto not_plain;
            }
        }
        Py_DECREF(ports);
        PyObject *res = PyObject_GetAttr(cont, str_resources);
        PyObject *reqs = res ? PyObject_GetAttr(res, str_requests) : NULL;
        Py_XDECREF(res);
        if (reqs == NULL)
            goto error;
        if (!PyDict_Check(reqs)) {
            Py_DECREF(reqs);
            goto not_plain;
        }
        PyObject *rk, *rv;
        Py_ssize_t rpos = 0;
        while (PyDict_Next(reqs, &rpos, &rk, &rv)) {
            if (!PyLong_Check(rv)) {
                Py_DECREF(reqs);
                goto not_plain;
            }
            PyObject *cur = PyDict_GetItemWithError(req, rk);
            if (cur == NULL && PyErr_Occurred()) {
                Py_DECREF(reqs);
                goto error;
            }
            PyObject *sum;
            if (cur == NULL) {
                sum = rv;
                Py_INCREF(sum);
            } else {
                sum = PyNumber_Add(cur, rv);
                if (sum == NULL) {
                    Py_DECREF(reqs);
                    goto error;
                }
            }
            int sr = PyDict_SetItem(req, rk, sum);
            Py_DECREF(sum);
            if (sr < 0) {
                Py_DECREF(reqs);
                goto error;
            }
        }
        /* non-zero defaults (util/non_zero.go semantics) */
        PyObject *ccpu = PyDict_GetItemWithError(reqs, cfg[3]);
        if (ccpu == NULL && PyErr_Occurred()) {
            Py_DECREF(reqs);
            goto error;
        }
        PyObject *cmem = PyDict_GetItemWithError(reqs, cfg[4]);
        if (cmem == NULL && PyErr_Occurred()) {
            Py_DECREF(reqs);
            goto error;
        }
        nzr_cpu += (ccpu != NULL && PyObject_IsTrue(ccpu) == 1)
                       ? PyLong_AsLongLong(ccpu)
                       : default_cpu;
        nzr_mem += (cmem != NULL && PyObject_IsTrue(cmem) == 1)
                       ? PyLong_AsLongLong(cmem)
                       : default_mem;
        Py_DECREF(reqs);
        if (PyErr_Occurred())
            goto error;
    }
    for (Py_ssize_t c = 0; c < PyList_GET_SIZE(inits); c++) {
        PyObject *cont = PyList_GET_ITEM(inits, c);
        PyObject *res = PyObject_GetAttr(cont, str_resources);
        PyObject *reqs = res ? PyObject_GetAttr(res, str_requests) : NULL;
        Py_XDECREF(res);
        if (reqs == NULL)
            goto error;
        if (!PyDict_Check(reqs)) {
            Py_DECREF(reqs);
            goto not_plain;
        }
        PyObject *rk, *rv;
        Py_ssize_t rpos = 0;
        while (PyDict_Next(reqs, &rpos, &rk, &rv)) {
            if (!PyLong_Check(rv)) {
                Py_DECREF(reqs);
                goto not_plain;
            }
            PyObject *cur = PyDict_GetItemWithError(req, rk);
            if (cur == NULL && PyErr_Occurred()) {
                Py_DECREF(reqs);
                goto error;
            }
            /* Python twin: `if qty > out.get(name, 0)` -- an absent
             * name compares against 0 */
            PyObject *zero = PyLong_FromLong(0);
            if (zero == NULL) {
                Py_DECREF(reqs);
                goto error;
            }
            int gt = PyObject_RichCompareBool(rv, cur ? cur : zero, Py_GT);
            Py_DECREF(zero);
            if (gt < 0) {
                Py_DECREF(reqs);
                goto error;
            }
            if (gt && PyDict_SetItem(req, rk, rv) < 0) {
                Py_DECREF(reqs);
                goto error;
            }
        }
        Py_DECREF(reqs);
    }
    {
        PyObject *rk, *rv;
        Py_ssize_t rpos = 0;
        while (PyDict_Next(overhead, &rpos, &rk, &rv)) {
            if (!PyLong_Check(rv))
                goto not_plain;
            PyObject *cur = PyDict_GetItemWithError(req, rk);
            if (cur == NULL && PyErr_Occurred())
                goto error;
            PyObject *sum;
            if (cur == NULL) {
                sum = rv;
                Py_INCREF(sum);
            } else {
                sum = PyNumber_Add(cur, rv);
                if (sum == NULL)
                    goto error;
            }
            int sr = PyDict_SetItem(req, rk, sum);
            Py_DECREF(sum);
            if (sr < 0)
                goto error;
        }
    }

    /* -- build + install the memos ----------------------------------- */
    {
        PyObject *zero = PyLong_FromLong(0);
        PyObject *items = NULL, *scalar = NULL, *hot = NULL, *nzr = NULL;
        PyObject *packrow = NULL, *key = NULL;
        PyObject *cpu_q = NULL, *mem_q = NULL, *eph_q = NULL;
        PyObject *nzr_cpu_obj = NULL, *nzr_mem_obj = NULL, *kib_obj = NULL;
        PyObject *d = NULL;
        int ok = 0;
        if (zero == NULL)
            goto build_done;

        Py_ssize_t nreq = PyDict_GET_SIZE(req);
        items = PyTuple_New(nreq);
        scalar = PyList_New(0);
        if (items == NULL || scalar == NULL)
            goto build_done;
        {
            PyObject *rk, *rv;
            Py_ssize_t rpos = 0, j = 0;
            while (PyDict_Next(req, &rpos, &rk, &rv)) {
                PyObject *pair = PyTuple_Pack(2, rk, rv);
                if (pair == NULL)
                    goto build_done;
                PyTuple_SET_ITEM(items, j++, pair);
                int fixed =
                    PyObject_RichCompareBool(rk, cfg[3], Py_EQ) == 1 ||
                    PyObject_RichCompareBool(rk, cfg[4], Py_EQ) == 1 ||
                    PyObject_RichCompareBool(rk, cfg[5], Py_EQ) == 1 ||
                    PyObject_RichCompareBool(rk, cfg[6], Py_EQ) == 1;
                if (PyErr_Occurred())
                    goto build_done;
                if (!fixed) {
                    PyObject *spair = PyTuple_Pack(2, rk, rv);
                    if (spair == NULL)
                        goto build_done;
                    int ap = PyList_Append(scalar, spair);
                    Py_DECREF(spair);
                    if (ap < 0)
                        goto build_done;
                }
            }
        }
        cpu_q = PyDict_GetItemWithError(req, cfg[3]);
        mem_q = PyDict_GetItemWithError(req, cfg[4]);
        eph_q = PyDict_GetItemWithError(req, cfg[5]);
        if (PyErr_Occurred())
            goto build_done;
        if (cpu_q == NULL)
            cpu_q = zero;
        if (mem_q == NULL)
            mem_q = zero;
        if (eph_q == NULL)
            eph_q = zero;
        nzr_cpu_obj = PyLong_FromLongLong(nzr_cpu);
        nzr_mem_obj = PyLong_FromLongLong(nzr_mem);
        kib_obj = PyLong_FromLongLong(kib_ceil_ll(nzr_mem));
        if (nzr_cpu_obj == NULL || nzr_mem_obj == NULL || kib_obj == NULL)
            goto build_done;
        {
            PyObject *scalar_t = PyList_AsTuple(scalar);
            if (scalar_t == NULL)
                goto build_done;
            PyObject *empty = PyTuple_New(0);
            if (empty == NULL) {
                Py_DECREF(scalar_t);
                goto build_done;
            }
            hot = PyTuple_Pack(8, cpu_q, mem_q, eph_q, scalar_t,
                               nzr_cpu_obj, nzr_mem_obj, Py_False, empty);
            Py_DECREF(scalar_t);
            Py_DECREF(empty);
        }
        nzr = PyTuple_Pack(2, nzr_cpu_obj, nzr_mem_obj);
        if (hot == NULL || nzr == NULL)
            goto build_done;
        {
            PyObject *empty = PyTuple_New(0);
            if (empty == NULL)
                goto build_done;
            key = PyTuple_Pack(2, items, empty);
            Py_DECREF(empty);
        }
        if (key == NULL)
            goto build_done;
        packrow = PyTuple_Pack(4, key, nzr_cpu_obj, kib_obj, prio);
        if (packrow == NULL)
            goto build_done;

        d = PyObject_GetAttr(pod, str_dict);
        if (d == NULL || !PyDict_Check(d))
            goto build_done;
        if (PyDict_SetItem(d, str_req_memo, req) < 0 ||
            PyDict_SetItem(d, str_nzr_memo, nzr) < 0 ||
            PyDict_SetItem(d, str_hot_memo, hot) < 0 ||
            PyDict_SetItem(d, str_packrow, packrow) < 0 ||
            PyDict_SetItem(d, str_band_priority, prio) < 0 ||
            PyDict_SetItem(d, str_admission, cfg[0]) < 0)
            goto build_done;
        ok = 1;
    build_done:
        Py_XDECREF(zero);
        Py_XDECREF(items);
        Py_XDECREF(scalar);
        Py_XDECREF(hot);
        Py_XDECREF(nzr);
        Py_XDECREF(key);
        Py_XDECREF(packrow);
        Py_XDECREF(nzr_cpu_obj);
        Py_XDECREF(nzr_mem_obj);
        Py_XDECREF(kib_obj);
        Py_XDECREF(d);
        if (!ok)
            goto error;
    }
    plain = 1;
    goto done;

not_plain:
    /* several gates route a FAILED truth test here ("broken shape: let
     * the Python classifier own the error") -- the pending exception
     * must not leak into the caller's success return */
    PyErr_Clear();
    plain = 0;
    goto done;
error:
    plain = -1;
done:
    Py_XDECREF(spec);
    Py_XDECREF(meta);
    Py_XDECREF(req);
    Py_XDECREF(containers);
    Py_XDECREF(inits);
    Py_XDECREF(overhead);
    Py_XDECREF(prio);
    return plain;
}

static PyObject *
ingest_stamp(PyObject *self, PyObject *args)
{
    /* ingest_stamp(pods, cfg) -> [index of non-plain pods]
     *
     * One C pass over a watch frame's new pending pods: plain pods get
     * their full ingest record (memos + shared Admission) stamped here;
     * the returned indices take the full Python classifier. Semantics:
     * scheduler/admission.py stamp_plain_pods (the differential
     * twin). */
    PyObject *pods, *cfg_t;
    if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &pods,
                          &PyTuple_Type, &cfg_t))
        return NULL;
    if (PyTuple_GET_SIZE(cfg_t) != 9) {
        PyErr_SetString(PyExc_ValueError, "ingest_stamp cfg must have 9 items");
        return NULL;
    }
    PyObject *cfg[9];
    for (int i = 0; i < 9; i++)
        cfg[i] = PyTuple_GET_ITEM(cfg_t, i);
    long long default_cpu = PyLong_AsLongLong(cfg[7]);
    long long default_mem = PyLong_AsLongLong(cfg[8]);
    if (PyErr_Occurred())
        return NULL;
    PyObject *rest = PyList_New(0);
    if (rest == NULL)
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(pods);
    for (Py_ssize_t i = 0; i < n; i++) {
        int r = stamp_one(PyList_GET_ITEM(pods, i), cfg, default_cpu,
                          default_mem);
        if (r < 0) {
            /* a broken pod object routes to the Python classifier,
             * which owns the error handling (classify wraps in
             * try/except) -- the fast path never half-stamps */
            PyErr_Clear();
            r = 0;
        }
        if (r == 0) {
            PyObject *idx = PyLong_FromSsize_t(i);
            if (idx == NULL) {
                Py_DECREF(rest);
                return NULL;
            }
            int ap = PyList_Append(rest, idx);
            Py_DECREF(idx);
            if (ap < 0) {
                Py_DECREF(rest);
                return NULL;
            }
        }
    }
    return rest;
}

static PyObject *
pack_gather(PyObject *self, PyObject *args)
{
    /* pack_gather(pods, stamp, row_cache, idx, nzr, prio) -> new_keys
     *
     * The pack-ready-row gather: per pod, read the _packrow memo
     * (calling back into `stamp` for the rare miss), dedup its request
     * key through `row_cache` (key -> uniq index), and write
     * idx/nzr/prio straight into the caller's preallocated int32
     * buffers. Returns the DISTINCT keys first seen this call, in
     * order -- the only per-row work left in Python is encoding those
     * few distinct rows against the schema. Twin:
     * tensors/node_tensor.py _pack_gather_py. */
    PyObject *pods, *stamp, *row_cache;
    Py_buffer idx_buf, nzr_buf, prio_buf;
    if (!PyArg_ParseTuple(args, "O!OO!w*w*w*", &PyList_Type, &pods, &stamp,
                          &PyDict_Type, &row_cache, &idx_buf, &nzr_buf,
                          &prio_buf))
        return NULL;
    Py_ssize_t b = PyList_GET_SIZE(pods);
    PyObject *new_keys = NULL;
    if ((Py_ssize_t)(idx_buf.len) < b * 4 ||
        (Py_ssize_t)(nzr_buf.len) < b * 8 ||
        (Py_ssize_t)(prio_buf.len) < b * 4) {
        PyErr_SetString(PyExc_ValueError, "pack_gather buffers too small");
        goto out;
    }
    new_keys = PyList_New(0);
    if (new_keys == NULL)
        goto out;
    {
        int32_t *idx32 = (int32_t *)idx_buf.buf;
        int32_t *nzr32 = (int32_t *)nzr_buf.buf;
        int32_t *prio32 = (int32_t *)prio_buf.buf;
        for (Py_ssize_t i = 0; i < b; i++) {
            PyObject *pod = PyList_GET_ITEM(pods, i);
            PyObject *d = PyObject_GetAttr(pod, str_dict);
            if (d == NULL)
                goto fail;
            PyObject *memo =
                PyDict_Check(d) ? PyDict_GetItemWithError(d, str_packrow)
                                : NULL;
            Py_XINCREF(memo);
            Py_DECREF(d);
            if (memo == NULL) {
                if (PyErr_Occurred())
                    goto fail;
                memo = PyObject_CallFunctionObjArgs(stamp, pod, NULL);
                if (memo == NULL)
                    goto fail;
            }
            if (!PyTuple_Check(memo) || PyTuple_GET_SIZE(memo) != 4) {
                Py_DECREF(memo);
                PyErr_SetString(PyExc_TypeError, "bad _packrow memo");
                goto fail;
            }
            PyObject *key = PyTuple_GET_ITEM(memo, 0);
            PyObject *u_obj = PyDict_GetItemWithError(row_cache, key);
            long u;
            if (u_obj == NULL) {
                if (PyErr_Occurred()) {
                    Py_DECREF(memo);
                    goto fail;
                }
                u = (long)PyDict_GET_SIZE(row_cache);
                PyObject *u_new = PyLong_FromLong(u);
                if (u_new == NULL ||
                    PyDict_SetItem(row_cache, key, u_new) < 0 ||
                    PyList_Append(new_keys, key) < 0) {
                    Py_XDECREF(u_new);
                    Py_DECREF(memo);
                    goto fail;
                }
                Py_DECREF(u_new);
            } else {
                u = PyLong_AsLong(u_obj);
                if (u == -1 && PyErr_Occurred()) {
                    Py_DECREF(memo);
                    goto fail;
                }
            }
            long long cpu = PyLong_AsLongLong(PyTuple_GET_ITEM(memo, 1));
            long long mem = PyLong_AsLongLong(PyTuple_GET_ITEM(memo, 2));
            long long pr = PyLong_AsLongLong(PyTuple_GET_ITEM(memo, 3));
            Py_DECREF(memo);
            if (PyErr_Occurred())
                goto fail;
            /* the Python twin's numpy int32 assignment raises
             * OverflowError on out-of-range values -- silent wraparound
             * here would corrupt the fit/score inputs and diverge the
             * two paths */
            if (cpu < INT32_MIN || cpu > INT32_MAX ||
                mem < INT32_MIN || mem > INT32_MAX ||
                pr < INT32_MIN || pr > INT32_MAX) {
                PyErr_SetString(PyExc_OverflowError,
                                "_packrow value out of int32 range");
                goto fail;
            }
            idx32[i] = (int32_t)u;
            nzr32[2 * i] = (int32_t)cpu;
            nzr32[2 * i + 1] = (int32_t)mem;
            prio32[i] = (int32_t)pr;
        }
    }
    goto out;
fail:
    Py_XDECREF(new_keys);
    new_keys = NULL;
out:
    PyBuffer_Release(&idx_buf);
    PyBuffer_Release(&nzr_buf);
    PyBuffer_Release(&prio_buf);
    return new_keys;
}

static PyObject *
queue_shape(PyObject *self, PyObject *args)
{
    /* queue_shape(pods) -> (keys, prios, noms)
     *
     * One C pass shaping a create burst for the bulk activeQ add:
     * "ns/name" key strings (the heap's key space), spec.priority (the
     * PrioritySort sort-key component), and status.nominated_node_name
     * per pod. Twin: queue/scheduling_queue.py _queue_shape_py. */
    PyObject *pods;
    if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &pods))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(pods);
    PyObject *keys = PyList_New(n);
    PyObject *prios = PyList_New(n);
    PyObject *noms = PyList_New(n);
    if (keys == NULL || prios == NULL || noms == NULL)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *pod = PyList_GET_ITEM(pods, i);
        PyObject *meta = PyObject_GetAttr(pod, str_metadata);
        if (meta == NULL)
            goto fail;
        PyObject *ns = PyObject_GetAttr(meta, str_namespace);
        PyObject *name = PyObject_GetAttr(meta, str_name);
        Py_DECREF(meta);
        if (ns == NULL || name == NULL) {
            Py_XDECREF(ns);
            Py_XDECREF(name);
            goto fail;
        }
        PyObject *key = PyUnicode_FromFormat("%U/%U", ns, name);
        Py_DECREF(ns);
        Py_DECREF(name);
        if (key == NULL)
            goto fail;
        PyList_SET_ITEM(keys, i, key);
        PyObject *spec = PyObject_GetAttr(pod, str_spec);
        PyObject *prio = spec ? PyObject_GetAttr(spec, str_priority) : NULL;
        Py_XDECREF(spec);
        if (prio == NULL)
            goto fail;
        PyList_SET_ITEM(prios, i, prio);
        PyObject *status = PyObject_GetAttr(pod, str_status);
        PyObject *nom =
            status ? PyObject_GetAttr(status, str_nominated) : NULL;
        Py_XDECREF(status);
        if (nom == NULL)
            goto fail;
        PyList_SET_ITEM(noms, i, nom);
    }
    return Py_BuildValue("(NNN)", keys, prios, noms);
fail:
    Py_XDECREF(keys);
    Py_XDECREF(prios);
    Py_XDECREF(noms);
    return NULL;
}

static PyObject *
mirror_scatter(PyObject *self, PyObject *args)
{
    /* mirror_scatter(a, req, nzr, req_shadow, nzr_shadow,
     *                rows_out, req_out, nzr_out) -> k
     *
     * The bind-echo -> shadow-mirror hot loop (ISSUE 18): one pass over
     * the batch's int32 assignments compacts the placed rows into
     * rows_out/req_out/nzr_out AND scatter-adds the per-pod demand into
     * the int32 shadow expectation, replacing the committer's
     * fancy-index + two np.add.at passes. Every index is validated
     * BEFORE any buffer is mutated so a failure here can always fall
     * back to the Python twin (scheduler/batch.py _mirror_scatter_py)
     * without double-applying. Layout contract (all C-contiguous):
     * a int32[b], req int32[b,r], nzr int32[b,2], req_shadow int32[n,r]
     * (writable), nzr_shadow int32[n,2] (writable), rows_out int64[b],
     * req_out int32[b,r], nzr_out int32[b,2]. */
    Py_buffer a_buf, req_buf, nzr_buf, rs_buf, ns_buf;
    Py_buffer ro_buf, qo_buf, zo_buf;
    if (!PyArg_ParseTuple(args, "y*y*y*w*w*w*w*w*", &a_buf, &req_buf,
                          &nzr_buf, &rs_buf, &ns_buf, &ro_buf, &qo_buf,
                          &zo_buf))
        return NULL;
    PyObject *ret = NULL;
    Py_ssize_t b = a_buf.len / 4;
    Py_ssize_t n = ns_buf.len / 8;
    Py_ssize_t r = (b > 0) ? req_buf.len / (4 * b) : 0;
    if (b == 0) {
        ret = PyLong_FromSsize_t(0);
        goto out;
    }
    if (r <= 0 || req_buf.len != b * r * 4 || nzr_buf.len != b * 8 ||
        rs_buf.len != n * r * 4 || ns_buf.len != n * 8 ||
        ro_buf.len < b * 8 || qo_buf.len < b * r * 4 ||
        zo_buf.len < b * 8) {
        PyErr_SetString(PyExc_ValueError,
                        "mirror_scatter buffer shape mismatch");
        goto out;
    }
    {
        const int32_t *a32 = (const int32_t *)a_buf.buf;
        const int32_t *q32 = (const int32_t *)req_buf.buf;
        const int32_t *z32 = (const int32_t *)nzr_buf.buf;
        int32_t *rs32 = (int32_t *)rs_buf.buf;
        int32_t *ns32 = (int32_t *)ns_buf.buf;
        int64_t *ro64 = (int64_t *)ro_buf.buf;
        int32_t *qo32 = (int32_t *)qo_buf.buf;
        int32_t *zo32 = (int32_t *)zo_buf.buf;
        /* validate-before-mutate: the twin must stay a safe retry */
        for (Py_ssize_t i = 0; i < b; i++) {
            int32_t v = a32[i];
            if (v != -1 && (v < 0 || (Py_ssize_t)v >= n)) {
                PyErr_SetString(PyExc_ValueError,
                                "mirror_scatter assignment out of range");
                goto out;
            }
        }
        Py_ssize_t k = 0;
        for (Py_ssize_t i = 0; i < b; i++) {
            int32_t v = a32[i];
            if (v == -1)
                continue;
            const int32_t *qrow = q32 + i * r;
            int32_t *srow = rs32 + (Py_ssize_t)v * r;
            int32_t *orow = qo32 + k * r;
            for (Py_ssize_t j = 0; j < r; j++) {
                srow[j] += qrow[j];
                orow[j] = qrow[j];
            }
            ns32[2 * v] += z32[2 * i];
            ns32[2 * v + 1] += z32[2 * i + 1];
            zo32[2 * k] = z32[2 * i];
            zo32[2 * k + 1] = z32[2 * i + 1];
            ro64[k] = (int64_t)v;
            k++;
        }
        ret = PyLong_FromSsize_t(k);
    }
out:
    PyBuffer_Release(&a_buf);
    PyBuffer_Release(&req_buf);
    PyBuffer_Release(&nzr_buf);
    PyBuffer_Release(&rs_buf);
    PyBuffer_Release(&ns_buf);
    PyBuffer_Release(&ro_buf);
    PyBuffer_Release(&qo_buf);
    PyBuffer_Release(&zo_buf);
    return ret;
}

static PyMethodDef methods[] = {
    {"match_compiled", match_compiled, METH_VARARGS,
     "match_compiled(labels, compiled) -> bool"},
    {"match_mask", match_mask, METH_VARARGS,
     "match_mask(labels_list, compiled) -> bytes"},
    {"dict_covers", dict_covers, METH_VARARGS,
     "dict_covers(labels, selector_dict) -> bool"},
    {"cow_clone", cow_clone, METH_VARARGS,
     "cow_clone(obj, attr_names) -> shallow clone with named attrs "
     "also shallow-cloned"},
    {"assume_clones", assume_clones, METH_VARARGS,
     "assume_clones(pods, hosts) -> [assumed clone with spec.node_name "
     "set]"},
    {"commit_gather", commit_gather, METH_VARARGS,
     "commit_gather(solver_infos, order, assignments, names) -> "
     "(pod_infos, clones, hosts)"},
    {"bind_assumed_bulk", bind_assumed_bulk, METH_VARARGS,
     "bind_assumed_bulk(store, assumed_list, rv, event_cls) -> "
     "(errors, events, new_rv)"},
    {"ingest_decode", ingest_decode, METH_VARARGS,
     "ingest_decode(events) -> [key]: memoize per-event key records"},
    {"ingest_apply", ingest_apply, METH_VARARGS,
     "ingest_apply(store, events) -> [(etype, old, new)]"},
    {"ingest_stamp", ingest_stamp, METH_VARARGS,
     "ingest_stamp(pods, cfg) -> [non-plain indices]; plain pods get "
     "their full ingest record stamped in C"},
    {"pack_gather", pack_gather, METH_VARARGS,
     "pack_gather(pods, stamp, row_cache, idx, nzr, prio) -> new_keys"},
    {"queue_shape", queue_shape, METH_VARARGS,
     "queue_shape(pods) -> (keys, prios, noms)"},
    {"mirror_scatter", mirror_scatter, METH_VARARGS,
     "mirror_scatter(a, req, nzr, req_shadow, nzr_shadow, rows_out, "
     "req_out, nzr_out) -> placed count k"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hotpath",
    "native label-selector matching (SURVEY section 2.4 host data plane)",
    -1, methods,
};

PyMODINIT_FUNC
PyInit__hotpath(void)
{
    str_dict = PyUnicode_InternFromString("__dict__");
    str_spec = PyUnicode_InternFromString("spec");
    str_node_name = PyUnicode_InternFromString("node_name");
    str_metadata = PyUnicode_InternFromString("metadata");
    str_namespace = PyUnicode_InternFromString("namespace");
    str_name = PyUnicode_InternFromString("name");
    str_uid = PyUnicode_InternFromString("uid");
    str_resource_version = PyUnicode_InternFromString("resource_version");
    str_sig_memo = PyUnicode_InternFromString("_sig_memo");
    str_modified = PyUnicode_InternFromString("MODIFIED");
    str_pod = PyUnicode_InternFromString("pod");
    str_obj_attr = PyUnicode_InternFromString("object");
    str_type_attr = PyUnicode_InternFromString("type");
    str_decoded = PyUnicode_InternFromString("decoded");
    str_added = PyUnicode_InternFromString("ADDED");
    str_deleted = PyUnicode_InternFromString("DELETED");
    str_status = PyUnicode_InternFromString("status");
    str_nominated = PyUnicode_InternFromString("nominated_node_name");
    str_priority = PyUnicode_InternFromString("priority");
    str_priority_class = PyUnicode_InternFromString("priority_class_name");
    str_annotations = PyUnicode_InternFromString("annotations");
    str_labels = PyUnicode_InternFromString("labels");
    str_volumes = PyUnicode_InternFromString("volumes");
    str_affinity = PyUnicode_InternFromString("affinity");
    str_spread =
        PyUnicode_InternFromString("topology_spread_constraints");
    str_containers = PyUnicode_InternFromString("containers");
    str_init_containers = PyUnicode_InternFromString("init_containers");
    str_overhead = PyUnicode_InternFromString("overhead");
    str_resources = PyUnicode_InternFromString("resources");
    str_requests = PyUnicode_InternFromString("requests");
    str_ports = PyUnicode_InternFromString("ports");
    str_host_port = PyUnicode_InternFromString("host_port");
    str_packrow = PyUnicode_InternFromString("_packrow");
    str_band_priority = PyUnicode_InternFromString("_band_priority");
    str_admission = PyUnicode_InternFromString("_admission");
    str_req_memo = PyUnicode_InternFromString("_req_memo");
    str_nzr_memo = PyUnicode_InternFromString("_nzr_memo");
    str_hot_memo = PyUnicode_InternFromString("_hot_memo");
    if (str_dict == NULL || str_spec == NULL || str_node_name == NULL ||
        str_metadata == NULL || str_namespace == NULL ||
        str_name == NULL || str_uid == NULL || str_resource_version == NULL ||
        str_sig_memo == NULL || str_modified == NULL || str_pod == NULL ||
        str_obj_attr == NULL || str_type_attr == NULL ||
        str_decoded == NULL || str_added == NULL || str_deleted == NULL ||
        str_status == NULL || str_nominated == NULL ||
        str_priority == NULL || str_priority_class == NULL ||
        str_annotations == NULL || str_labels == NULL ||
        str_volumes == NULL || str_affinity == NULL || str_spread == NULL ||
        str_containers == NULL || str_init_containers == NULL ||
        str_overhead == NULL || str_resources == NULL ||
        str_requests == NULL || str_ports == NULL ||
        str_host_port == NULL || str_packrow == NULL ||
        str_band_priority == NULL || str_admission == NULL ||
        str_req_memo == NULL || str_nzr_memo == NULL ||
        str_hot_memo == NULL)
        return NULL;
    return PyModule_Create(&moduledef);
}
