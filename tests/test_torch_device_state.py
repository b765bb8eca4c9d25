"""The resident carry's handshake, on the CPU, in both packages.

Twins of the cases of ``tests/test_device_state.py`` that reach code the
port rewrote (``scheduler/batch.py``'s ``_negotiate_device_state`` and the
carry bookkeeping around it). Each case runs the same event sequence
through the JAX package's ``new_scheduler(..., batch=True)`` and through
the port's (``device="cpu"``), holds each package to the reference's
assertions, and compares, call by call:

- the dict ``_negotiate_device_state`` returns (``static_ok``,
  ``carry_ok``, ``didx``, ``sidx``, ``member``; or None for a drain);
- ``state_uploads``, ``state_reuses``, ``carry_divergences``,
  ``delta_rows_uploaded``, ``membership_row_patches`` and the length of
  the pending-delta ring;
- the shadow after each call (``alloc_shadow``, ``valid_shadow``,
  ``req_shadow``, ``nzr_shadow``).

The reference fakes the resident device refs with ``object()``; the
port's twin hands real CPU tensors of the packed shapes instead (the
handshake reads only whether they are set).

Not twinned: the six ``TestTensorDelta*`` cases. ``tensors/node_tensor.py``
is identical in both packages, so their code is the reference's.

Two port differences are pinned here:

- The port has no ``allow_scatter`` argument. The reference's
  ``KTPU_MESH_DELTA=0`` escape hatch (``allow_scatter=False``: any change
  on a mesh resolves as a counted full upload) was not carried over; a
  port mesh negotiates as the reference does by default
  (``allow_scatter=True``).
- ``_DeviceNodeState.recheck_rows`` is port-only (rows holding a mirrored
  placement that never reached the host cache). With no row queued, it
  leaves every reference decision unchanged.
"""

import random
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import kubernetes_tpu.api.types as jax_types
import kubernetes_tpu.cache.cache as jax_cache
import kubernetes_tpu.cache.snapshot as jax_snapshot
import kubernetes_tpu.robustness.ladder as jax_ladder
import kubernetes_tpu.scheduler.batch as jax_batch
import kubernetes_tpu.tensors as jax_tensors
import kubernetes_tpu_torch.api.types as port_types
import kubernetes_tpu_torch.cache.cache as port_cache
import kubernetes_tpu_torch.cache.snapshot as port_snapshot
import kubernetes_tpu_torch.robustness.ladder as port_ladder
import kubernetes_tpu_torch.scheduler.batch as port_batch
import kubernetes_tpu_torch.tensors as port_tensors
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.ops.mesh import NodeMesh
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

PKG = {
    "jax": SimpleNamespace(
        server=JaxAPIServer, client=JaxClient, informers=JaxInformers,
        new=jax_new, node=jax_node, pod=jax_pod, types=jax_types,
        SchedulerCache=jax_cache.SchedulerCache,
        Snapshot=jax_snapshot.Snapshot,
        new_snapshot=jax_snapshot.new_snapshot,
        NodeTensorCache=jax_tensors.NodeTensorCache, batch=jax_batch,
        ladder=jax_ladder, kw={},
        # the reference's default: the mesh rides the scatters too
        neg_kw={"allow_scatter": True},
    ),
    "torch": SimpleNamespace(
        server=APIServer, client=Client, informers=InformerFactory,
        new=new_scheduler, node=make_node, pod=make_pod, types=port_types,
        SchedulerCache=port_cache.SchedulerCache,
        Snapshot=port_snapshot.Snapshot,
        new_snapshot=port_snapshot.new_snapshot,
        NodeTensorCache=port_tensors.NodeTensorCache, batch=port_batch,
        ladder=port_ladder, kw={"device": "cpu"}, neg_kw={},
    ),
}
BOTH = ("jax", "torch")


def _stack(pkg, max_batch=16, **kw):
    P = PKG[pkg]
    server = P.server()
    client = P.client(server)
    informers = P.informers(server)
    sched = P.new(client, informers, batch=True, max_batch=max_batch,
                  **P.kw, **kw)
    return client, informers, sched


@pytest.fixture
def stacks():
    """One batch scheduler per package, stopped at teardown."""
    made = {}

    def get(pkg, **kw):
        made[pkg] = _stack(pkg, **kw)
        return made[pkg][2]

    yield get
    for _client, informers, sched in made.values():
        sched.stop()
        informers.stop()


def _cluster(P, n):
    cache = P.SchedulerCache()
    for i in range(n):
        cache.add_node(
            P.node(f"hs-{i}").capacity(cpu="8", memory="16Gi").obj()
        )
    snap = P.Snapshot()
    cache.update_snapshot(snap)
    return cache, snap


def _negotiate(P, sched, nt, **kw):
    kw.setdefault("overlaid", False)
    kw.setdefault("pending_exists", False)
    return sched._negotiate_device_state(
        nt, nt.requested, nt.non_zero_requested, **{**P.neg_kw, **kw}
    )


def _fake_refs(pkg, sched, nt):
    """The resident refs a solve would have produced. The reference's
    test sets ``object()``; the port's twin sets CPU tensors of the packed
    shapes. Their content is irrelevant to the handshake."""
    ds = sched._dev
    if pkg == "jax":
        ds.alloc_dev = object()
        ds.valid_dev = object()
        ds.req_dev = object()
        ds.nzr_dev = object()
        return
    ds.alloc_dev = torch.as_tensor(nt.allocatable)
    ds.valid_dev = torch.as_tensor(nt.valid.astype(np.int32))
    ds.req_dev = torch.as_tensor(nt.requested)
    ds.nzr_dev = torch.as_tensor(nt.non_zero_requested)


def _prime(pkg, sched, nt):
    """First dispatch: the full-upload route, then the faked refs."""
    neg = _negotiate(PKG[pkg], sched, nt)
    assert neg == {
        "static_ok": False,
        "carry_ok": False,
        "didx": neg["didx"],
        "sidx": neg["sidx"],
        "member": 0,
    }
    _fake_refs(pkg, sched, nt)
    return neg


def _mirror(sched, rows, req_rows, nzr_rows):
    """What _complete_solve does when a batch commits."""
    ds = sched._dev
    with sched._shadow_lock:
        np.add.at(ds.req_shadow, rows, req_rows)
        np.add.at(ds.nzr_shadow, rows, nzr_rows)
        ds.pending_deltas.append((rows, req_rows, nzr_rows))


def _pod_rows(nt, k):
    r = nt.dims.num_dims
    req_rows = np.zeros((1, r), dtype=np.int32)
    req_rows[0, 0] = 500  # 500m cpu
    req_rows[0, 3] = 1  # pod count
    nzr_rows = np.asarray([[500, 128]], dtype=np.int32)
    return np.asarray([k], dtype=np.int64), req_rows, nzr_rows


def _decision(sched, neg):
    """One negotiation and the bookkeeping it left, as plain values."""
    ds = sched._dev
    out = {
        "neg": None if neg is None else {
            "static_ok": bool(neg["static_ok"]),
            "carry_ok": bool(neg["carry_ok"]),
            "didx": np.asarray(neg["didx"]).tolist(),
            "sidx": np.asarray(neg["sidx"]).tolist(),
            "member": int(neg["member"]),
        },
        "ring": len(ds.pending_deltas),
        "validated_epoch": ds.validated_epoch,
        "layout_epoch": ds.layout_epoch,
    }
    for k in ("state_uploads", "state_reuses", "carry_divergences",
              "delta_rows_uploaded", "membership_row_patches",
              "speculative_rewinds"):
        out[k] = getattr(sched, k)
    for k in ("alloc_shadow", "valid_shadow", "req_shadow", "nzr_shadow"):
        a = getattr(ds, k)
        out[k] = None if a is None else np.asarray(a).tolist()
    return out


class _Log:
    """Every negotiation of one package's run, with its bookkeeping."""

    def __init__(self, pkg, sched):
        self.pkg = pkg
        self.P = PKG[pkg]
        self.sched = sched
        self.calls = []

    def neg(self, nt, **kw):
        neg = _negotiate(self.P, self.sched, nt, **kw)
        self.calls.append(_decision(self.sched, neg))
        return neg

    def prime(self, nt):
        neg = _prime(self.pkg, self.sched, nt)
        self.calls.append(_decision(self.sched, neg))
        return neg


def _twin(stacks, scenario, **kw):
    """Run ``scenario(log)`` in both packages; the decisions must agree
    call for call."""
    logs = {}
    for pkg in BOTH:
        logs[pkg] = _Log(pkg, stacks(pkg, **kw))
        scenario(logs[pkg])
    assert logs["jax"].calls, "the scenario negotiated nothing"
    assert len(logs["torch"].calls) == len(logs["jax"].calls)
    for i, (want, got) in enumerate(zip(logs["jax"].calls,
                                        logs["torch"].calls)):
        assert got == want, f"negotiation {i} differs from the JAX package's"
    return logs


# -- scenarios: the reference's TestHandshake, package-agnostic -------------

def _steady_state_pure_reuse(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    log.prime(sched.tensor_cache.update(snap))
    assert sched.state_uploads == 1
    neg = log.neg(sched.tensor_cache.update(snap))
    assert neg["carry_ok"] and neg["static_ok"]
    assert neg["didx"].size == 0 and neg["sidx"].size == 0
    assert sched.state_reuses == 1
    assert sched.delta_rows_uploaded == 0


def _own_commit_explained_by_mirror(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    nt = sched.tensor_cache.update(snap)
    log.prime(nt)
    _mirror(sched, *_pod_rows(nt, 2))
    pod = P.pod("own").node("hs-2").container(cpu="500m").obj()
    pod.__dict__["_nzr_memo"] = (500, 128 * 1024)
    cache.add_pod(pod)
    cache.update_snapshot(snap)
    nt = sched.tensor_cache.update(snap)
    assert nt.delta.changed_rows.tolist() == [2]
    neg = log.neg(nt)
    assert neg["carry_ok"]
    assert neg["didx"].size == 0
    assert sched.state_uploads == 1
    assert len(sched._dev.pending_deltas) == 0


def _ahead_by_k_committer_lag(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    nt = sched.tensor_cache.update(snap)
    log.prime(nt)
    k = P.batch._SHADOW_RING_CAP - 1
    for i in range(k):
        _mirror(sched, *_pod_rows(nt, i % 5))
    neg = log.neg(sched.tensor_cache.update(snap), pending_exists=True)
    assert neg is not None and neg["carry_ok"]
    assert len(sched._dev.pending_deltas) == k
    assert sched.state_uploads == 1


def _ring_overflow_degrades_to_counted_upload(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    nt = sched.tensor_cache.update(snap)
    log.prime(nt)
    cap = P.batch._SHADOW_RING_CAP
    for i in range(cap + 2):
        _mirror(sched, *_pod_rows(nt, i % 5))
    assert len(sched._dev.pending_deltas) == cap
    for i in range(5):
        cache.add_pod(
            P.pod(f"lag-{i}").node(f"hs-{i}").container(cpu="250m").obj()
        )
    cache.update_snapshot(snap)
    neg = log.neg(sched.tensor_cache.update(snap))
    assert not neg["carry_ok"]
    assert sched.state_uploads == 2
    assert sched.carry_divergences >= 1


def _external_divergence_scatter_fixed(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    pod = P.pod("ext").node("hs-3").container(cpu="1").obj()
    cache.add_pod(pod)
    cache.update_snapshot(snap)
    log.prime(sched.tensor_cache.update(snap))
    cache.remove_pod(pod)
    cache.update_snapshot(snap)
    nt = sched.tensor_cache.update(snap)
    neg = log.neg(nt)
    assert neg["carry_ok"]
    assert neg["didx"].tolist() == [3]
    assert sched.carry_divergences == 1
    assert sched.delta_rows_uploaded == 1
    assert sched.state_uploads == 1
    assert np.array_equal(sched._dev.req_shadow[3], nt.requested[3])


def _divergence_with_inflight_batches_drains(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    pod = P.pod("ext2").node("hs-1").container(cpu="1").obj()
    cache.add_pod(pod)
    cache.update_snapshot(snap)
    log.prime(sched.tensor_cache.update(snap))
    cache.remove_pod(pod)
    cache.update_snapshot(snap)
    assert log.neg(sched.tensor_cache.update(snap),
                   pending_exists=True) is None


def _allocatable_change_rides_scatter(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    log.prime(sched.tensor_cache.update(snap))
    cache.add_node(P.node("hs-4").capacity(cpu="32", memory="64Gi").obj())
    cache.update_snapshot(snap)
    nt = sched.tensor_cache.update(snap)
    neg = log.neg(nt)
    assert neg["carry_ok"] and neg["static_ok"]
    assert neg["sidx"].tolist() == [4]
    assert sched.delta_rows_uploaded == 1
    assert np.array_equal(sched._dev.alloc_shadow[4], nt.allocatable[4])


def _node_add_rides_membership_scatter(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    log.prime(sched.tensor_cache.update(snap))
    cache.add_node(P.node("hs-new").capacity(cpu="8", memory="16Gi").obj())
    cache.update_snapshot(snap)
    nt = sched.tensor_cache.update(snap)
    assert not nt.delta.full
    new_row = nt.row("hs-new")
    assert nt.delta.membership_rows.tolist() == [new_row]
    neg = log.neg(nt)
    assert neg["static_ok"] and neg["carry_ok"]
    assert neg["sidx"].tolist() == [new_row]
    assert neg["member"] == 1
    assert sched.state_uploads == 1
    assert sched.state_reuses == 1
    assert sched.membership_row_patches == 1
    assert sched.carry_divergences == 0
    assert np.array_equal(
        sched._dev.req_shadow[new_row], nt.requested[new_row]
    )


def _node_remove_rides_membership_scatter(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    pod = P.pod("on3").node("hs-3").container(cpu="1").obj()
    cache.add_pod(pod)
    cache.update_snapshot(snap)
    nt = sched.tensor_cache.update(snap)
    row3 = nt.row("hs-3")
    log.prime(nt)
    cache.remove_pod(pod)
    cache.remove_node(P.types.Node(metadata=P.types.ObjectMeta(name="hs-3")))
    cache.update_snapshot(snap)
    nt = sched.tensor_cache.update(snap)
    assert not nt.delta.full
    assert nt.delta.membership_rows.tolist() == [row3]
    assert nt.names[row3] == ""
    assert not nt.valid[row3]
    neg = log.neg(nt)
    assert neg["static_ok"] and neg["carry_ok"]
    assert neg["sidx"].tolist() == [row3]
    assert neg["didx"].tolist() == [row3]
    assert sched.state_uploads == 1
    assert sched.carry_divergences == 0
    assert sched.membership_row_patches == 1
    assert (sched._dev.req_shadow[row3] == 0).all()


def _membership_with_inflight_batches_drains(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    log.prime(sched.tensor_cache.update(snap))
    cache.add_node(P.node("hs-new").capacity(cpu="8", memory="16Gi").obj())
    cache.update_snapshot(snap)
    assert log.neg(sched.tensor_cache.update(snap),
                   pending_exists=True) is None


def _headroom_exhaustion_full_repacks_once(log):
    P, sched = log.P, log.sched
    cache, snap = _cluster(P, 5)
    nt = sched.tensor_cache.update(snap)
    cap = nt.capacity
    log.prime(nt)
    tc = sched.tensor_cache
    for i in range(cap - 5 + 1):  # one past the allocated capacity
        cache.add_node(
            P.node(f"hs-x{i}").capacity(cpu="8", memory="16Gi").obj()
        )
    cache.update_snapshot(snap)
    nt = tc.update(snap)
    assert nt.delta.full
    assert tc.full_repacks == 2
    assert nt.capacity > cap
    neg = log.neg(nt)
    assert not neg["static_ok"] and not neg["carry_ok"]
    assert sched.state_uploads == 2


HANDSHAKE = {
    "steady_state_pure_reuse": _steady_state_pure_reuse,
    "own_commit_explained_by_mirror": _own_commit_explained_by_mirror,
    "ahead_by_k_committer_lag": _ahead_by_k_committer_lag,
    "ring_overflow_degrades_to_counted_upload":
        _ring_overflow_degrades_to_counted_upload,
    "external_divergence_scatter_fixed": _external_divergence_scatter_fixed,
    "divergence_with_inflight_batches_drains":
        _divergence_with_inflight_batches_drains,
    "allocatable_change_rides_scatter": _allocatable_change_rides_scatter,
    "node_add_rides_membership_scatter": _node_add_rides_membership_scatter,
    "node_remove_rides_membership_scatter":
        _node_remove_rides_membership_scatter,
    "membership_with_inflight_batches_drains":
        _membership_with_inflight_batches_drains,
    "headroom_exhaustion_full_repacks_once":
        _headroom_exhaustion_full_repacks_once,
}


class TestHandshake:
    def test_ring_cap_matches_the_reference(self):
        assert port_batch._SHADOW_RING_CAP == jax_batch._SHADOW_RING_CAP

    @pytest.mark.parametrize("case", sorted(HANDSHAKE))
    def test_twin(self, stacks, case):
        _twin(stacks, HANDSHAKE[case])

    def test_mesh_negotiates_as_the_reference_default(self, stacks):
        """A mesh scheduler negotiates as the reference's default
        (``allow_scatter=True``): an external change rides the row
        scatter. The reference's ``KTPU_MESH_DELTA=0`` fallback
        (``allow_scatter=False``: a counted full upload) was not carried
        over, so the port has no such decision; the last run below only
        records that the reference would make it."""

        def scenario(log):
            P, sched = log.P, log.sched
            cache, snap = _cluster(P, 5)
            pod = P.pod("m").node("hs-0").container(cpu="1").obj()
            cache.add_pod(pod)
            cache.update_snapshot(snap)
            log.prime(sched.tensor_cache.update(snap))
            cache.remove_pod(pod)
            cache.update_snapshot(snap)
            neg = log.neg(sched.tensor_cache.update(snap))
            assert neg["carry_ok"]
            assert neg["didx"].tolist() == [0]
            assert neg["sidx"].size == 0
            assert sched.state_uploads == 1
            assert sched.carry_divergences == 1

        logs = {}
        for pkg, mesh in (
            ("jax", Mesh(np.array(jax.devices()[:2]), axis_names=("nodes",))),
            ("torch", NodeMesh(["cpu"] * 2)),
        ):
            logs[pkg] = _Log(pkg, stacks(pkg, mesh=mesh))
            scenario(logs[pkg])
        assert logs["jax"].sched.mesh_delta  # the reference's default
        assert logs["torch"].calls == logs["jax"].calls
        assert not hasattr(logs["torch"].sched, "mesh_delta")

        # the reference's escape hatch, for the record: a full upload
        P = PKG["jax"]
        _client, informers, sched = _stack("jax")
        try:
            cache, snap = _cluster(P, 5)
            pod = P.pod("m").node("hs-0").container(cpu="1").obj()
            cache.add_pod(pod)
            cache.update_snapshot(snap)
            _prime("jax", sched, sched.tensor_cache.update(snap))
            cache.remove_pod(pod)
            cache.update_snapshot(snap)
            neg = _negotiate(
                P, sched, sched.tensor_cache.update(snap), allow_scatter=False
            )
            assert not neg["carry_ok"]
            assert sched.state_uploads == 2
        finally:
            sched.stop()
            informers.stop()

    def test_recheck_rows_unqueued_leaves_every_decision(self, stacks):
        """``recheck_rows`` is port-only. With no row queued, a sequence
        through every route (reuse, mirror, scatter-fix, membership
        scatter, a drain, a counted upload) decides as the JAX package,
        and the set stays empty after every call."""
        empties = []

        def scenario(log):
            P, sched = log.P, log.sched
            cache, snap = _cluster(P, 5)
            nt = sched.tensor_cache.update(snap)
            log.prime(nt)
            log.neg(sched.tensor_cache.update(snap))
            _mirror(sched, *_pod_rows(nt, 1))
            pod = P.pod("own").node("hs-1").container(cpu="500m").obj()
            pod.__dict__["_nzr_memo"] = (500, 128 * 1024)
            cache.add_pod(pod)
            cache.update_snapshot(snap)
            log.neg(sched.tensor_cache.update(snap))
            cache.remove_pod(pod)
            cache.add_node(P.node("hs-new").capacity(cpu="8").obj())
            cache.update_snapshot(snap)
            nt = sched.tensor_cache.update(snap)
            assert log.neg(nt, pending_exists=True) is None
            log.neg(nt)
            for i in range(P.batch._SHADOW_RING_CAP + 1):
                _mirror(sched, *_pod_rows(nt, i % 5))
            cache.add_pod(P.pod("lag").node("hs-2").container(cpu="1").obj())
            cache.update_snapshot(snap)
            log.neg(sched.tensor_cache.update(snap))
            if log.pkg == "torch":
                empties.append(not sched._dev.recheck_rows)

        logs = _twin(stacks, scenario)
        assert empties == [True]
        moved = logs["torch"].calls[-1]
        assert moved["state_uploads"] == 2 and moved["carry_divergences"] >= 2


class TestRandomizedMembershipChurn:
    def test_differential_vs_fresh_pack(self, stacks):
        """Interleaved node add/remove/reorder and external pod churn at
        the reference's seed: the carry stays warm on scatters, the
        shadow equals host truth, the pack equals a fresh full pack, and
        both packages decide alike at every step."""

        def scenario(log):
            P, sched = log.P, log.sched
            rng = random.Random(20260803)
            cache = P.SchedulerCache()
            nodes, pods_by_node, seq = {}, {}, [0]

            def new_node():
                name = f"rc-{seq[0]}"
                seq[0] += 1
                node = P.node(name).capacity(
                    cpu="16", memory="32Gi", pods=64).obj()
                nodes[name] = node
                pods_by_node[name] = []
                cache.add_node(node)

            for _ in range(12):
                new_node()
            snap = P.Snapshot()
            cache.update_snapshot(snap)
            tc = sched.tensor_cache
            nt = tc.update(snap)
            capacity0 = nt.capacity
            layout0 = tc.layout_epoch
            log.prime(nt)
            uploads0 = sched.state_uploads
            for step in range(80):
                op = rng.choice(
                    ["add", "remove", "reorder", "pod_add", "pod_del"])
                if op == "add" and len(nodes) < capacity0 - 2:
                    new_node()
                elif op == "remove" and len(nodes) > 3:
                    name = rng.choice(sorted(nodes))
                    for p in pods_by_node.pop(name):
                        cache.remove_pod(p)
                    del nodes[name]
                    cache.remove_node(P.types.Node(
                        metadata=P.types.ObjectMeta(name=name)))
                elif op == "reorder":
                    names = list(snap.node_info_map)
                    rng.shuffle(names)
                    snap.node_info_map = {
                        n: snap.node_info_map[n] for n in names}
                    snap.refresh_lists()
                elif op == "pod_add":
                    name = rng.choice(sorted(nodes))
                    p = P.pod(f"rp-{step}").node(name).container(
                        cpu="250m", memory="256Mi").obj()
                    pods_by_node[name].append(p)
                    cache.add_pod(p)
                else:
                    cands = [n for n in sorted(nodes) if pods_by_node[n]]
                    if not cands:
                        continue
                    p = pods_by_node[rng.choice(cands)].pop()
                    cache.remove_pod(p)
                cache.update_snapshot(snap)
                nt = tc.update(snap)
                neg = log.neg(nt)
                assert neg is not None, f"step {step}: drain demanded"
                assert neg["carry_ok"], f"step {step}: carry dropped"
                s = len(nt.names)
                assert np.array_equal(
                    sched._dev.req_shadow[:s], nt.requested[:s]
                ), f"step {step}: shadow != host"
                fresh = P.NodeTensorCache().update(P.new_snapshot(
                    [p for ps in pods_by_node.values() for p in ps],
                    list(nodes.values())))
                assert sorted(n for n in nt.names if n) == sorted(
                    fresh.names)
                for name in nodes:
                    i, k = nt.row(name), fresh.row(name)
                    assert np.array_equal(nt.requested[i],
                                          fresh.requested[k])
                    assert np.array_equal(nt.allocatable[i],
                                          fresh.allocatable[k])
                    assert np.array_equal(nt.non_zero_requested[i],
                                          fresh.non_zero_requested[k])
                    assert nt.valid[i]
                for i, name in enumerate(nt.names):
                    if not name:
                        assert not nt.valid[i]
                        assert (nt.allocatable[i] == 0).all()
                        assert (nt.requested[i] == 0).all()
            assert tc.layout_epoch == layout0
            assert tc.full_repacks == 1
            assert sched.state_uploads == uploads0

        logs = _twin(stacks, scenario)
        assert len(logs["torch"].calls) > 60


class TestApplyAssignmentDelta:
    def test_no_node_slots_drop_instead_of_wrapping(self):
        """NO_NODE (-1) and past-the-end slots drop in both packages: the
        port's torch scatter equals the JAX function on the same inputs,
        and neither touches the last row."""
        import jax.numpy as jnp

        from kubernetes_tpu.ops.assignment import (
            apply_assignment_delta as jax_apply,
        )
        from kubernetes_tpu_torch.ops.assignment import (
            NO_NODE,
            apply_assignment_delta,
        )

        assigns = np.asarray([NO_NODE, 2, NO_NODE, 7], dtype=np.int32)
        pod_req = np.full((4, 3), 5, dtype=np.int32)
        pod_nzr = np.full((4, 2), 7, dtype=np.int32)
        req2, nzr2 = apply_assignment_delta(
            torch.zeros((4, 3), dtype=torch.int32),
            torch.zeros((4, 2), dtype=torch.int32),
            assigns, pod_req, pod_nzr,
        )
        want_req, want_nzr = jax_apply(
            jnp.zeros((4, 3), dtype=jnp.int32),
            jnp.zeros((4, 2), dtype=jnp.int32),
            assigns, pod_req, pod_nzr,
        )
        assert req2.dtype == torch.int32 and nzr2.dtype == torch.int32
        assert np.array_equal(req2.numpy(), np.asarray(want_req))
        assert np.array_equal(nzr2.numpy(), np.asarray(want_nzr))
        assert req2[2].tolist() == [5, 5, 5]
        assert nzr2[2].tolist() == [7, 7]
        for i in (0, 1, 3):
            assert req2[i].tolist() == [0, 0, 0], f"row {i} corrupted"
            assert nzr2[i].tolist() == [0, 0], f"row {i} corrupted"


def _host_tier_after_layout_change(pkg, monkeypatch):
    """The reference's host-tier bookkeeping case in package ``pkg``;
    returns what the twin compares."""
    P = PKG[pkg]
    client, informers, sched = _stack(pkg, max_batch=8)
    tier_host = P.ladder.TIER_HOST_GREEDY
    seen = []

    def one_batch():
        deadline = time.time() + 10
        while time.time() < deadline:
            if sched.schedule_batch(timeout=0.2):
                break
        sched.wait_for_inflight_binds(timeout=30)
        seen.append((sched.state_uploads, sched.state_reuses,
                     sched._dev.alloc_dev is None,
                     sched._dev.valid_dev is None))

    for i in range(3):
        client.create_node(
            P.node(f"ht-{i}").capacity(cpu="8", memory="16Gi").obj())
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    try:
        client.create_pod(P.pod("ht-p0").container(cpu="100m").obj())
        one_batch()
        assert sched._dev.alloc_dev is not None
        assert sched.state_uploads == 1
        client.create_node(
            P.node("ht-new").capacity(cpu="8", memory="16Gi").obj())
        deadline = time.time() + 10
        while time.time() < deadline and "ht-new" not in sched.cache._nodes:
            time.sleep(0.02)
        orig_run = sched.ladder.run

        def host_only(attempts, label="batch"):
            for tier, thunk in attempts:
                if tier == tier_host:
                    return tier, thunk()
            return orig_run(attempts, label=label)

        monkeypatch.setattr(sched.ladder, "run", host_only)
        client.create_pod(P.pod("ht-p1").container(cpu="100m").obj())
        one_batch()
        assert sched._dev.alloc_dev is None, (
            "stale device alloc survived a host-tier solve that never "
            "uploaded the new layout"
        )
        assert sched._dev.valid_dev is None
        monkeypatch.setattr(sched.ladder, "run", orig_run)
        uploads = sched.state_uploads
        client.create_pod(P.pod("ht-p2").container(cpu="100m").obj())
        one_batch()
        assert sched.state_uploads == uploads + 1
        bound = {p.metadata.name: p.spec.node_name
                 for p in client.list_pods()[0] if p.spec.node_name}
        assert len(bound) == 3
        return seen, sorted(bound)
    finally:
        sched.stop()
        informers.stop()


class TestHostTierAllocBookkeeping:
    def test_host_tier_after_layout_change_drops_stale_alloc(
        self, monkeypatch
    ):
        """A layout change booked as a full static upload, then solved on
        the host tier: the stale resident alloc drops, and the next
        device dispatch uploads in full -- in both packages, with the
        same counters after each batch."""
        want = _host_tier_after_layout_change("jax", monkeypatch)
        monkeypatch.undo()
        got = _host_tier_after_layout_change("torch", monkeypatch)
        assert got == want
