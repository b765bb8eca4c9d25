"""The port's constrained solve against the JAX package's.

Small constrained batches are packed by the JAX package's own family
packers from seeded clusters (24 nodes, 3 zones, 24 pods, existing pods
with affinity terms, a Service, soft spread, PreferNoSchedule taints,
preferred node affinity, nodes lacking a topology label and nodes that
fill up), and the same numpy arrays go through:

- the port's plain version ``greedy_assign_constrained`` and JAX's XLA
  scan ``greedy_assign_constrained``: over several seeds, with each
  family alone (the others as no-op tensors), and on 64Gi nodes whose
  memKiB sums pass 2^24;
- the port's constrained solve at each family's live rows (``live_rows``)
  and the Pallas kernel ``pallas_constrained_solve`` in interpret mode at
  the JAX package's caps for the same batch, and both with every family
  absent (zero rows, zero caps);
- the port's ``solve_packed(mode="constrained")`` and JAX's on identical
  piece lists: the cold, refresh and steady layouts, absent families as
  ConstPiece constants.

Every compared value is an integer (assignments, requested', nzr', rows),
so the tolerance is zero. The CUDA kernel (K2) cannot run here;
chip_smoke.py holds it against this plain version on the card.
"""

import math
import random

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubernetes_tpu.api.types import ObjectMeta, Service
from kubernetes_tpu.cache.snapshot import new_snapshot
from kubernetes_tpu.ops import assignment as jax_asg
from kubernetes_tpu.ops import pallas_constrained as jax_pc
from kubernetes_tpu.ops.affinity import (
    noop_affinity_tensors,
    pack_affinity_batch,
    pad_affinity_tensors,
)
from kubernetes_tpu.ops.host_masks import static_mask_compact
from kubernetes_tpu.ops.scoring import (
    noop_score_tensors,
    pack_score_batch,
    pad_score_tensors,
)
from kubernetes_tpu.ops.topology import (
    noop_spread_tensors,
    pack_spread_batch,
    pad_spread_tensors,
)
from kubernetes_tpu.scheduler import batch as jax_batch
from kubernetes_tpu.tensors import NodeTensorCache, pack_pod_batch
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch.ops import assignment as torch_asg
from kubernetes_tpu_torch.ops import constrained_kernel as ck

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
POD_BUCKET = 64
MASK_ROW_BUCKET = 8
WEIGHTS = {
    "NodeAffinity": 1,
    "TaintToleration": 1,
    "DefaultPodTopologySpread": 1,
    "PodTopologySpread": 2,
    "InterPodAffinity": 1,
}


class _Lister:
    def __init__(self, items=()):
        self._items = list(items)

    def list(self):
        return list(self._items)


class _Informers:
    """What the score packer reads of the informers: the owner objects
    whose selectors drive SelectorSpread."""

    def __init__(self, services):
        self._services = _Lister(services)

    def services(self):
        return self._services

    def replication_controllers(self):
        return _Lister()

    def replica_sets(self):
        return _Lister()

    def stateful_sets(self):
        return _Lister()


def _cluster(rng, memory, n_nodes=24):
    """Nodes without a zone or a rack label (ineligible for the families
    keyed on them), small nodes that fill up within the batch (so the
    feasible set shrinks step by step), PreferNoSchedule taints."""
    nodes = []
    for i in range(n_nodes):
        nd = (
            make_node(f"node-{i}")
            .capacity(cpu="1" if i % 5 == 4 else "16", memory=memory, pods=32)
            .label(HOST, f"node-{i}")
        )
        if i % 8 != 7:
            nd = nd.label(ZONE, f"zone-{i % 3}")
        if i % 6 != 5:
            nd = nd.label("rack", f"rack-{i % 5}")
        if i % 7 == 3:
            nd = nd.taint("flaky", "yes", effect="PreferNoSchedule")
        nodes.append(nd.obj())
    apps = ["a", "b", "c"]
    existing = []
    for i in range(rng.randrange(10, 30)):
        p = (
            make_pod(f"ex-{i}")
            .node(f"node-{rng.randrange(n_nodes)}")
            .container(cpu="200m", memory="256Mi")
            .labels(app=rng.choice(apps), svc=rng.choice(["web", "db"]))
        )
        roll = rng.random()
        if roll < 0.25:
            p = p.pod_affinity(ZONE, {"app": rng.choice(apps)}, anti=True)
        elif roll < 0.4:
            p = p.preferred_pod_affinity(
                "rack", {"app": rng.choice(apps)},
                weight=rng.randrange(1, 20), anti=rng.random() < 0.5,
            )
        existing.append(p.obj())
    return existing, nodes


def _batch(rng, b=24):
    apps = ["a", "b", "c"]
    out = []
    for i in range(b):
        app = rng.choice(apps)
        p = (
            make_pod(f"pod-{i}")
            .container(cpu="300m", memory="384Mi")
            .labels(app=app, svc=rng.choice(["web", "db", "none"]))
        )
        roll = rng.random()
        if roll < 0.15:
            p = p.pod_affinity(HOST, {"app": rng.choice(apps)}, anti=True)
        elif roll < 0.3:
            p = p.pod_affinity(ZONE, {"app": rng.choice(apps)})
        elif roll < 0.42:
            p = p.spread_constraint(
                max_skew=rng.randrange(1, 4), topology_key=ZONE,
                when_unsatisfiable="DoNotSchedule", match_labels={"app": app},
            )
        elif roll < 0.52:
            p = p.spread_constraint(
                max_skew=1, topology_key=rng.choice([ZONE, "rack"]),
                when_unsatisfiable="ScheduleAnyway", match_labels={"app": app},
            )
        elif roll < 0.66:
            p = p.preferred_pod_affinity(
                ZONE, {"app": rng.choice(apps)},
                weight=rng.randrange(1, 30), anti=rng.random() < 0.4,
            )
        elif roll < 0.74:
            p = p.preferred_node_affinity_in("rack", ["rack-1", "rack-2"])
        out.append(p.obj())
    return out


def _packed_problem(seed, memory="32Gi"):
    """Mirror the batch scheduler's packing for a constrained batch (no
    nominees, no gangs): host arrays and the three padded family tuples."""
    rng = random.Random(seed)
    existing, nodes = _cluster(rng, memory)
    snap = new_snapshot(existing, nodes)
    nt = NodeTensorCache().update(snap)
    pods = _batch(rng)
    batch = pack_pod_batch(pods, nt.dims)
    mask_rows, mask_index = static_mask_compact(pods, snap, nt)
    if batch.unsatisfiable.any():
        mask_rows = np.concatenate(
            [mask_rows, np.zeros((1, nt.capacity), dtype=bool)]
        )
        mask_index = mask_index.copy()
        mask_index[batch.unsatisfiable] = mask_rows.shape[0] - 1
    b = batch.size
    padded = POD_BUCKET * math.ceil(b / POD_BUCKET)
    order = batch.order
    req = np.zeros((padded, nt.dims.num_dims), dtype=np.int32)
    nzr = np.zeros((padded, 2), dtype=np.int32)
    midx = np.zeros(padded, dtype=np.int32)
    active = np.zeros(padded, dtype=bool)
    req[:b] = batch.requests[order]
    nzr[:b] = batch.non_zero_requests[order]
    midx[:b] = mask_index[order]
    active[:b] = True
    u = mask_rows.shape[0]
    rows = np.zeros(
        (MASK_ROW_BUCKET * math.ceil(u / MASK_ROW_BUCKET), nt.capacity),
        dtype=bool,
    )
    rows[:u] = mask_rows
    ordered = [pods[int(i)] for i in order]
    services = [
        Service(metadata=ObjectMeta(name="web", namespace="default"),
                selector={"svc": "web"})
    ]
    sp = pack_spread_batch(ordered, snap, nt)
    af = pack_affinity_batch(ordered, snap, nt)
    sc = pack_score_batch(
        ordered, snap, nt, _Informers(services), WEIGHTS,
        hard_pod_affinity_weight=1, cluster_affinity_scoring=None,
    )
    assert sp is not None and af is not None and sc is not None
    common = (
        np.asarray(nt.allocatable), np.asarray(nt.requested),
        np.asarray(nt.non_zero_requested), np.asarray(nt.valid),
        req, nzr, rows, midx, active,
    )
    fams = (
        tuple(pad_spread_tensors(sp, padded)),
        tuple(pad_affinity_tensors(af, padded)),
        tuple(pad_score_tensors(sc, padded)),
    )
    noops = (
        tuple(noop_spread_tensors(padded, nt.capacity)),
        tuple(noop_affinity_tensors(padded, nt.capacity)),
        tuple(noop_score_tensors(padded, nt.capacity)),
    )
    return common, fams, noops


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _tuple(arrs):
    return tuple(_t(a) for a in arrs)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _both(common, fams):
    """(port's constrained solve, JAX XLA scan)."""
    want = jax_asg.greedy_assign_constrained(
        *common, *fams, config=jax_asg.GreedyConfig()
    )
    got = ck.constrained_solve(
        *(_t(a) for a in common), *(_tuple(f) for f in fams),
        config=torch_asg.GreedyConfig(),
    )
    return got, want


@pytest.mark.parametrize(
    "seed,memory",
    [(0, "32Gi"), (3, "32Gi"), (11, "32Gi"), (42, "32Gi"),
     (5, "64Gi"), (19, "64Gi")],
)
def test_plain_version_matches_the_xla_scan(seed, memory):
    common, fams, _ = _packed_problem(seed, memory)
    if memory == "64Gi":  # memKiB per node passes 2^24
        assert common[0][:, 1].max() > (1 << 24)
    got = torch_asg.greedy_assign_constrained(
        *(_t(a) for a in common), *(_tuple(f) for f in fams),
        config=torch_asg.GreedyConfig(),
    )
    want = jax_asg.greedy_assign_constrained(
        *common, *fams, config=jax_asg.GreedyConfig()
    )
    _assert_equal(got, want)
    assert (np.asarray(want[0]) >= 0).sum() > 0


@pytest.mark.parametrize("family", [0, 1, 2], ids=["spread", "affinity",
                                                   "scoring"])
def test_each_family_alone_matches_the_xla_scan(family):
    common, fams, noops = _packed_problem(3)
    alone = tuple(
        fams[k] if k == family else noops[k] for k in range(3)
    )
    got, want = _both(common, alone)
    _assert_equal(got, want)


@pytest.mark.parametrize("caps", ["default_live", "zero"])
@pytest.mark.parametrize("seed", [0, 11])
def test_plain_version_at_caps_matches_the_pallas_kernel(seed, caps):
    """The Pallas kernel at the DEFAULT_LIVE caps (at or above this
    batch's live rows) against the port at the live rows; and with every
    family absent, the Pallas kernel at zero caps against the port at
    zero rows."""
    common, fams, noops = _packed_problem(seed)
    if caps == "default_live":
        jcaps, rows = jax_pc.DEFAULT_LIVE, ck.live_rows(*fams)
        assert all(r <= c for r, c in zip(rows, jcaps))
    else:
        fams = noops
        jcaps, rows = jax_pc.Caps(0, 0, 0, 0, 0, 0, 0), ck.Rows(0, 0, 0, 0,
                                                                 0, 0, 0)
    want = jax_pc.pallas_constrained_solve(
        *common, *fams, config=jax_asg.GreedyConfig(), interpret=True,
        caps=jcaps,
    )
    got = ck.constrained_solve(
        *(_t(a) for a in common), *(_tuple(f) for f in fams),
        config=torch_asg.GreedyConfig(), rows=rows,
    )
    _assert_equal(got, want)


def test_live_rows_count_what_the_jax_package_counts():
    """live_rows counts each family's rows as the JAX package's
    caps_for_families does before it pads them up to DEFAULT_LIVE: its
    caps are live_caps of exactly these counts."""
    for seed in (0, 3, 11, 42):
        _, fams, _ = _packed_problem(seed)
        for present in [(True, True, True), (True, False, True),
                        (False, True, False)]:
            rows = ck.live_rows(
                *(f if on else None for f, on in zip(fams, present))
            )
            want = jax_asg.caps_for_families(*fams, *present)
            got = jax_pc.live_caps(
                *present, rows.g_sp, (rows.ra, rows.rt, rows.re),
                (rows.gt, rows.rp, rows.g_sel),
            )
            assert tuple(got) == tuple(want)
            assert all(r <= c for r, c in zip(rows, want))
        assert ck.live_rows(None, None, None) == ck.Rows(0, 0, 0, 0, 0, 0, 0)


def test_affinity_node_ok_matches_the_jax_package():
    _, fams, _ = _packed_problem(42)
    af = fams[1]
    vals = [
        jax_asg.row_node_values(jnp.asarray(af[0]), jnp.asarray(af[k]))
        for k in (2, 7, 11)
    ]
    tvals = [
        torch_asg.row_node_values(_t(af[0]), _t(af[k])) for k in (2, 7, 11)
    ]
    for jv, tv in zip(vals, tvals):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for t in range(24):
        want = jax_asg.affinity_node_ok(
            af[1], af[6], af[10], *vals, af[3][t], af[4][t], af[8][t],
            af[12][t],
        )
        got = torch_asg.affinity_node_ok(
            _t(af[1]), _t(af[6]), _t(af[10]), *tvals, _t(af[3][t]),
            torch.tensor(bool(af[4][t])), _t(af[8][t]), _t(af[12][t]),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_zone_blend_rounds_as_the_reference_compiles_it():
    """``f_node / 3.0 + (2.0 / 3.0) * f_zone`` as XLA evaluates it (a
    reciprocal multiply fused with the add) against the port's
    float64-emulated FMA, on values in the blend's [0, 100] range and on
    exact halfway cases."""
    rng = np.random.default_rng(0)
    a = (rng.random(100_000) * 100).astype(np.float32)
    b = (rng.random(100_000) * 100).astype(np.float32)
    a[:3] = [100.0, 0.0, 50.0]
    b[:3] = [100.0, 100.0, 0.0]
    want = np.asarray(jax.jit(lambda x, y: x / 3.0 + (2.0 / 3.0) * y)(a, b))
    got = torch_asg._fma32(
        torch.from_numpy(a), torch_asg._THIRD,
        torch_asg._TWO_THIRDS * torch.from_numpy(b),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def _layouts(common, fams, noops, const_piece):
    """The cold, refresh and steady piece lists of one constrained
    dispatch: the affinity family absent (a ConstPiece of the given
    package), spread and scoring riding the buffer."""
    alloc, req_state, nzr_state, valid, req, nzr, rows, midx, active = common
    n, r = alloc.shape
    base = [
        ("req", req), ("nzr", nzr), ("midx", midx),
        ("active", active.astype(np.int32)),
        ("rows", rows.astype(np.int32)),
    ]
    fam = (
        [(f"sp{i}", np.asarray(a)) for i, a in enumerate(fams[0])]
        + [(f"af{i}", const_piece.from_uniform(a))
           for i, a in enumerate(noops[1])]
        + [(f"sc{i}", np.asarray(a)) for i, a in enumerate(fams[2])]
    )
    static = [("alloc", alloc), ("valid", valid.astype(np.int32))]
    carry = [("req_state", req_state), ("nzr_state", nzr_state)]
    delta = jax_batch._delta_slot_pieces(n, r)
    return {
        "cold": (base + static + carry + fam, False, False),
        "refresh": (base + carry + fam, True, False),
        "steady": (base + delta + fam, True, True),
    }


@pytest.mark.parametrize("layout", ["cold", "refresh", "steady"])
def test_solve_packed_constrained_matches_the_jax_package(layout):
    common, fams, noops = _packed_problem(11)
    alloc, req_state, nzr_state, valid = common[:4]
    jp, static_in, carry_in = _layouts(
        common, fams, noops, jax_asg.ConstPiece
    )[layout]
    tp, _, _ = _layouts(common, fams, noops, torch_asg.ConstPiece)[layout]
    want = jax_asg.solve_packed(
        jp,
        jnp.asarray(alloc) if static_in else None,
        jnp.asarray(valid) if static_in else None,
        jnp.asarray(req_state) if carry_in else None,
        jnp.asarray(nzr_state) if carry_in else None,
        config=jax_asg.GreedyConfig(), mode="constrained",
    )
    got = torch_asg.solve_packed(
        tp,
        _t(alloc) if static_in else None,
        _t(valid) if static_in else None,
        _t(req_state) if carry_in else None,
        _t(nzr_state) if carry_in else None,
        config=torch_asg.GreedyConfig(), mode="constrained", device="cpu",
    )
    _assert_equal(got, want)
    assert ck.constrained_rows(dict(tp)) == ck.live_rows(
        fams[0], None, fams[2]
    )


def test_wrapper_takes_the_plain_version_on_the_cpu_and_raises_off_it():
    common, fams, _ = _packed_problem(0)
    targs = [_t(a) for a in common] + [_tuple(f) for f in fams]
    rows = ck.live_rows(*fams)
    got = ck.constrained_solve(*targs, rows=rows)
    want = torch_asg.greedy_assign_constrained(*targs)
    _assert_equal(got, [w.numpy() for w in want])
    with pytest.raises(ck.KernelError):
        ck.constrained_solve_cuda(*targs, rows=rows)
    meta = [a.to("meta") for a in targs[:9]] + [
        tuple(a.to("meta") for a in f) for f in targs[9:]
    ]
    with pytest.raises(ck.KernelError):
        ck.constrained_solve(*meta)
    assert "constrained_kernel" in torch_asg.kernel_build_counts()
