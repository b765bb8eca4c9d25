"""The port's native host data plane, on the CPU, against its own Python
fallbacks and against the JAX package's native module.

Twins of ``tests/test_native_commit.py`` and ``tests/
test_native_mirror.py``. ``kubernetes_tpu_torch.native`` builds its own
copy of ``_hotpath.c`` at first import; each case runs the same inputs
through the port's C entry point, the port's Python fallback, and the
JAX package's C entry point, and requires the same outcome: slots,
error types, store state, watch events and the assumed clones' sharing
structure for the commit spine (``assume_clones``, ``bind_assumed_bulk``,
``commit_gather``); bit-equal shadows and compacted rows for
``mirror_scatter``.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

import kubernetes_tpu.native as jax_native
import kubernetes_tpu_torch.native as native
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.framework.interface import PodInfo as JaxPodInfo
from kubernetes_tpu.scheduler.batch import (
    _commit_gather_py as jax_commit_gather_py,
)
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.api.types import Binding
from kubernetes_tpu_torch.apiserver import server as server_mod
from kubernetes_tpu_torch.apiserver.server import APIServer, Conflict, NotFound
from kubernetes_tpu_torch.cache.node_info import pod_hot_info
from kubernetes_tpu_torch.framework.interface import PodInfo
from kubernetes_tpu_torch.ops.assignment import NO_NODE
from kubernetes_tpu_torch.scheduler.batch import (
    _commit_gather_py,
    _mirror_scatter,
    _mirror_scatter_py,
)
from kubernetes_tpu_torch.testing import make_pod

if native.hotpath is None or jax_native.hotpath is None:  # pragma: no cover
    pytest.skip("a native module did not build", allow_module_level=True)


def _mk_pods(n, prefix="p", mk=make_pod):
    return [
        mk(f"{prefix}-{i}").container(cpu="100m", memory="128Mi").obj()
        for i in range(n)
    ]


# -- assume_clones vs Pod.assumed_clone ----------------------------------------


def test_assume_clones_matches_assumed_clone_and_the_jax_module():
    hosts = [f"node-{i}" for i in range(4)]
    pods = _mk_pods(4)
    clones = native.assume_clones(pods, hosts)
    for pod, host, clone in zip(pods, hosts, clones):
        ref = pod.assumed_clone()
        assert clone.spec.node_name == host
        assert pod.spec.node_name == ""
        # a fresh pod and spec; everything else shared, as assumed_clone
        assert clone is not pod and clone.spec is not pod.spec
        assert clone.metadata is pod.metadata is ref.metadata
        assert clone.status is pod.status
        assert clone.spec.containers is pod.spec.containers
        assert clone.kind == "Pod"
    jax_clones = jax_native.assume_clones(_mk_pods(4, mk=jax_pod), hosts)
    assert [c.spec.node_name for c in jax_clones] == [
        c.spec.node_name for c in clones
    ]
    assert [c.metadata.name for c in jax_clones] == [
        c.metadata.name for c in clones
    ]


def test_assume_clones_inherits_memos():
    pods = _mk_pods(2, "m")
    memo = pod_hot_info(pods[0])
    clones = native.assume_clones(pods, ["n1", "n2"])
    assert clones[0].__dict__.get("_hot_memo") == memo
    assert "_hot_memo" not in clones[1].__dict__


# -- bind_assumed_bulk: native vs fallback vs the JAX module ------------------


def _bind_scenario(pkg, use_native):
    """One mixed bulk bind: slot 1 a uid mismatch, slot 2 bound elsewhere,
    slot 3 a missing pod, slot 4 an empty target, slot 5 re-bound to its
    own node. Returns (error slots with type names, store, event names)."""
    if pkg == "jax":
        from kubernetes_tpu.api.types import Binding as B
        from kubernetes_tpu.apiserver import server as smod
        server, mk, mod = JaxAPIServer(), jax_pod, jax_native
    else:
        B, smod, server, mk, mod = Binding, server_mod, APIServer(), \
            make_pod, native
    pods = _mk_pods(6, "b", mk)
    server.create_bulk(pods)
    for slot, node in ((2, "elsewhere"), (5, "node-5")):
        server.bind(B(pod_namespace="default", pod_name=f"b-{slot}",
                      pod_uid=pods[slot].metadata.uid, target_node=node))
    watch = server.watch("Pod", since_rv=server.current_rv())
    assumed = mod.assume_clones(
        [server.get("Pod", "default", f"b-{i}") for i in range(6)],
        [f"node-{i}" for i in range(6)],
    )
    assumed[1].metadata = pods[1].metadata.__class__(
        name="b-1", namespace="default", uid="wrong-uid"
    )
    gone = mk("gone").container(cpu="1m", memory="1Mi").obj()
    assumed[3] = mod.assume_clones([gone], ["node-3"])[0]
    assumed[4].spec.node_name = ""
    if use_native:
        errors = server.bind_assumed_bulk(assumed)
    else:
        orig = smod._bind_assumed_bulk
        smod._bind_assumed_bulk = None
        try:
            errors = server.bind_assumed_bulk(assumed)
        finally:
            smod._bind_assumed_bulk = orig
    store = {
        f"b-{i}": server.get("Pod", "default", f"b-{i}").spec.node_name
        for i in range(6)
    }
    events = [
        (ev.type, ev.object.metadata.name, ev.resource_version)
        for ev in watch.pending()
    ]
    return [(i, type(e).__name__) for i, e in errors], store, events, errors


def test_bind_assumed_bulk_native_matches_fallback_and_the_jax_module():
    n_err, n_store, n_events, raw = _bind_scenario("torch", True)
    f_err, f_store, f_events, _ = _bind_scenario("torch", False)
    j_err, j_store, j_events, _ = _bind_scenario("jax", True)
    assert n_err == f_err == j_err
    assert [i for i, _ in n_err] == [1, 2, 3, 4]
    assert isinstance(raw[0][1], Conflict)
    assert isinstance(raw[1][1], Conflict)
    assert isinstance(raw[2][1], NotFound)
    assert isinstance(raw[3][1], ValueError)
    assert n_store == f_store == j_store
    assert n_store["b-0"] == "node-0"
    assert n_store["b-2"] == "elsewhere"
    assert n_store["b-4"] == ""
    assert n_store["b-5"] == "node-5"
    # one MODIFIED for slot 0; the same-node re-bind writes nothing
    assert n_events == f_events == j_events
    assert [(t, name) for t, name, _ in n_events] == [("MODIFIED", "b-0")]


def test_bind_assumed_bulk_cow_and_memo_semantics():
    server = APIServer()
    pods = _mk_pods(2, "c")
    server.create_bulk(pods)
    before = server.get("Pod", "default", "c-0")
    before.__dict__["_sig_memo"] = ("stale",)
    assert server.bind_assumed_bulk(
        native.assume_clones(pods, ["n-0", "n-1"])
    ) == []
    after = server.get("Pod", "default", "c-0")
    assert after is not before
    assert after.metadata is not before.metadata
    assert after.spec is not before.spec
    assert after.metadata.resource_version > before.metadata.resource_version
    assert "_sig_memo" not in after.__dict__
    assert before.spec.node_name == ""


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_bind_assumed_bulk_rv_matches_store_counter(pkg):
    server, mk, mod = (
        (JaxAPIServer(), jax_pod, jax_native) if pkg == "jax"
        else (APIServer(), make_pod, native)
    )
    pods = _mk_pods(3, "r", mk)
    server.create_bulk(pods)
    assert server.bind_assumed_bulk(
        mod.assume_clones(pods, ["x", "y", "z"])
    ) == []
    assert server.get("Pod", "default", "r-2").metadata.resource_version \
        == server.current_rv() == 6
    more = _mk_pods(1, "rr", mk)
    server.create_bulk(more)
    assert more[0].metadata.resource_version == server.current_rv() == 7


# -- commit_gather vs the Python fallback vs the JAX module -------------------


def _gather_inputs(n, nodes, seed, pkg="torch"):
    mk, info = (jax_pod, JaxPodInfo) if pkg == "jax" else (make_pod, PodInfo)
    rng = random.Random(seed)
    infos = [info(p, float(i)) for i, p in enumerate(_mk_pods(n, "g", mk))]
    names = [f"node-{i}" for i in range(nodes)]
    order = list(range(n))
    rng.shuffle(order)
    assigns = [rng.randrange(nodes) for _ in range(n)]
    return infos, order, assigns, names


def test_commit_gather_matches_fallback_and_the_jax_module():
    args = _gather_inputs(32, 7, 3)
    n_pis, n_clones, n_hosts = native.commit_gather(*args)
    p_pis, p_clones, p_hosts = _commit_gather_py(*args)
    jargs = _gather_inputs(32, 7, 3, "jax")
    j_pis, j_clones, j_hosts = jax_native.commit_gather(*jargs)
    jp_hosts = jax_commit_gather_py(*jargs)[2]
    assert n_hosts == p_hosts == j_hosts == jp_hosts
    names = [pi.pod.metadata.name for pi in n_pis]
    assert names == [pi.pod.metadata.name for pi in p_pis]
    assert names == [pi.pod.metadata.name for pi in j_pis]
    for nc, pc, host in zip(n_clones, p_clones, n_hosts):
        assert nc.spec.node_name == host == pc.spec.node_name
        assert nc.metadata is pc.metadata
        assert nc.spec.containers is pc.spec.containers
        assert nc.status is pc.status
    assert [c.spec.node_name for c in j_clones] == n_hosts


def test_commit_gather_leaves_originals_untouched():
    infos, order, assigns, names = _gather_inputs(8, 3, 5)
    native.commit_gather(infos, order, assigns, names)
    assert all(pi.pod.spec.node_name == "" for pi in infos)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_commit_gather_rejects_out_of_range(pkg):
    mod = jax_native if pkg == "jax" else native
    infos, order, assigns, names = _gather_inputs(4, 2, 1, pkg)
    with pytest.raises(IndexError):
        mod.commit_gather(infos, [0, 1, 99, 3], assigns, names)
    with pytest.raises(IndexError):
        mod.commit_gather(infos, order, [0, 1, 0, 99], names)
    with pytest.raises(ValueError):
        mod.commit_gather(infos, order[:2], assigns, names)


# -- mirror_scatter ------------------------------------------------------------


def _rand_case(rng):
    b = int(rng.integers(0, 48))
    r = int(rng.integers(1, 7))
    n = int(rng.integers(1, 40))
    a = rng.integers(-1, n, size=max(b, 1)).astype(np.int32)[:b]
    a[rng.random(b) < 0.3] = NO_NODE
    req = rng.integers(0, 5000, size=(b, r)).astype(np.int32)
    nzr = rng.integers(0, 5000, size=(b, 2)).astype(np.int32)
    req_shadow = rng.integers(0, 10000, size=(n, r)).astype(np.int32)
    nzr_shadow = rng.integers(0, 10000, size=(n, 2)).astype(np.int32)
    return a, b, req, nzr, req_shadow, nzr_shadow


def _call(fn, a, req, nzr, rs, ns):
    b = a.shape[0]
    rows = np.empty(b, dtype=np.int64)
    req_out = np.empty((b, req.shape[1]), dtype=np.int32)
    nzr_out = np.empty((b, 2), dtype=np.int32)
    k = fn(np.ascontiguousarray(a, dtype=np.int32), np.ascontiguousarray(req),
           np.ascontiguousarray(nzr), rs, ns, rows, req_out, nzr_out)
    return k, rows[:k], req_out[:k], nzr_out[:k]


def test_mirror_scatter_randomized_bit_equal_to_the_twin_and_the_jax_module():
    port_fn = native.hotpath.mirror_scatter
    jax_fn = jax_native.hotpath.mirror_scatter
    rng = np.random.default_rng(18)
    nonempty = 0
    for _ in range(300):
        a, b, req, nzr, rs, ns = _rand_case(rng)
        shadows = {k: (rs.copy(), ns.copy()) for k in ("port", "jax")}
        py = _mirror_scatter_py(a, b, req, nzr, rs, ns)
        got = {
            k: _call(fn, a[:b], req[:b], nzr[:b], *shadows[k])
            for k, fn in (("port", port_fn), ("jax", jax_fn))
        }
        for k in got:
            assert np.array_equal(rs, shadows[k][0])
            assert np.array_equal(ns, shadows[k][1])
            if py is None:
                assert got[k][0] == 0
            else:
                assert got[k][0] == py[0].size
                for out, want in zip(got[k][1:], py):
                    assert np.array_equal(out, want)
        nonempty += py is not None
    assert nonempty > 100


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_mirror_scatter_duplicate_targets_accumulate(pkg):
    fn = (jax_native if pkg == "jax" else native).hotpath.mirror_scatter
    a = np.array([2, 2, NO_NODE, 2], dtype=np.int32)
    rs = np.zeros((5, 3), dtype=np.int32)
    ns = np.zeros((5, 2), dtype=np.int32)
    k, rows, _, _ = _call(fn, a, np.full((4, 3), 10, np.int32),
                          np.full((4, 2), 7, np.int32), rs, ns)
    assert k == 3 and rows.tolist() == [2, 2, 2]
    assert rs[2].tolist() == [30, 30, 30]
    assert ns[2].tolist() == [21, 21]
    assert rs[[0, 1, 3, 4]].sum() == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_mirror_scatter_validates_before_mutating(pkg):
    fn = (jax_native if pkg == "jax" else native).hotpath.mirror_scatter
    rs = np.zeros((4, 3), dtype=np.int32)
    ns = np.zeros((4, 2), dtype=np.int32)
    with pytest.raises(ValueError):
        _call(fn, np.array([1, 99], np.int32), np.ones((2, 3), np.int32),
              np.ones((2, 2), np.int32), rs, ns)
    assert rs.sum() == 0 and ns.sum() == 0


def test_mirror_scatter_empty_batch():
    rs = np.zeros((3, 2), dtype=np.int32)
    ns = np.zeros((3, 2), dtype=np.int32)
    k, _, _, _ = _call(native.hotpath.mirror_scatter, np.empty(0, np.int32),
                       np.empty((0, 2), np.int32), np.empty((0, 2), np.int32),
                       rs, ns)
    assert k == 0 and rs.sum() == 0


@pytest.mark.parametrize("flag, seed, cases", [("0", 7, 1), ("1", 11, 20)])
def test_mirror_scatter_env_switch_matches_the_twin(monkeypatch, flag, seed,
                                                   cases):
    """KTPU_NATIVE_INGEST=0 takes the Python twin as the configured path;
    =1 the C entry point; both land the same shadows and rows."""
    monkeypatch.setenv("KTPU_NATIVE_INGEST", flag)
    assert native.ingest_on() is (flag == "1")
    rng = np.random.default_rng(seed)
    for _ in range(cases):
        a, b, req, nzr, rs, ns = _rand_case(rng)
        rs_c, ns_c = rs.copy(), ns.copy()
        out = _mirror_scatter(a, b, req, nzr, rs_c, ns_c)
        py = _mirror_scatter_py(a, b, req, nzr, rs, ns)
        assert np.array_equal(rs, rs_c) and np.array_equal(ns, ns_c)
        if py is None:
            assert out is None
        else:
            for got, want in zip(out, py):
                assert np.array_equal(got, want)
