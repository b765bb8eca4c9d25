"""The port's preemption wave against the JAX package's.

The plain version of kernel K3 (``kubernetes_tpu_torch/ops/preemption.py``
``preempt_batch_plain``) runs on the CPU against the JAX package's XLA
wave kernel ``_preempt_batch_kernel`` (with and without PDBs and
pre-existing nominations, over mixed classes of pods) and against the
Pallas kernel ``pallas_preempt_solve`` in interpret mode (waves without
PDBs, the only ones it takes). The same seeded numpy inputs go through
each and are compared bit for bit: chosen nodes, victim and violating
masks, violation counts and the post-wave carry are integers, and the
start-time key is the same float32 cast. The pack, its upload, the
whole device call and the port's Preemptor are held against the JAX
package and the host oracle on seeded clusters. The CUDA kernel cannot
run here; chip_smoke.py holds it against this plain version on the card.
"""

import random
import time

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import LabelSelector as JaxLabelSelector
from kubernetes_tpu.api.types import PodDisruptionBudget as JaxPDB
from kubernetes_tpu.cache.snapshot import new_snapshot as jax_new_snapshot
from kubernetes_tpu.ops import preemption as jax_pre
from kubernetes_tpu.ops.pallas_preempt import pallas_preempt_solve
from kubernetes_tpu.tensors import NodeTensorCache as JaxNodeTensorCache
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.api.types import LabelSelector, PodDisruptionBudget
from kubernetes_tpu_torch.cache.cache import SchedulerCache
from kubernetes_tpu_torch.cache.snapshot import Snapshot, new_snapshot
from kubernetes_tpu_torch.framework.interface import CycleState, FitError
from kubernetes_tpu_torch.framework.runtime import Framework
from kubernetes_tpu_torch.ops import preempt_kernel
from kubernetes_tpu_torch.ops import preemption as torch_pre
from kubernetes_tpu_torch.plugins import new_in_tree_registry
from kubernetes_tpu_torch.scheduler.generic import GenericScheduler
from kubernetes_tpu_torch.scheduler.preemption import (
    Preemptor,
    Victims,
    pick_one_node_for_preemption,
)
from kubernetes_tpu_torch.scheduler.provider import default_plugins
from kubernetes_tpu_torch.tensors import NodeTensorCache
from kubernetes_tpu_torch.testing import make_node, make_pod

_PRIO_FLOOR = -(1 << 31) + 1
M_SLOTS = 8  # nominations ride 8 slots, inactive ones at node -1


def _random_wave(seed, n=64, v=16, r=4, b=32, m=0, p=0, classes=False):
    """A wave after tests/test_pallas_preempt.py's: nodes holding 4..v-1
    victims in MoreImportantPod order, preemptors in priority-desc order.
    ``m`` live nominations (of M_SLOTS), ``p`` PDBs (some at zero
    budget), ``classes``: pods drawn from 4 priorities x 3 request rows
    x 4 candidate rows, so runs of pods share a class."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = 32000
    alloc[:, 1] = 64 << 20
    alloc[:, 3] = 110
    prio = np.full((n, v), _PRIO_FLOOR, np.int32)
    start = np.zeros((n, v), np.float32)
    req = np.zeros((n, v, r), np.int32)
    active = np.zeros((n, v), bool)
    base = np.zeros((n, r), np.int32)
    for i in range(n):
        k = rng.integers(4, v)
        prios = np.sort(rng.integers(-5, 50, k))[::-1]
        for j in range(k):
            active[i, j] = True
            prio[i, j] = prios[j]
            start[i, j] = np.float32(rng.random() * 100)
            req[i, j, 0] = rng.choice([1000, 3000, 5000])
            req[i, j, 1] = rng.choice([1, 2, 6]) << 20
            req[i, j, 3] = 1
        base[i] = req[i].sum(axis=0)
        # load beyond the victims (pods of higher priority than any
        # preemptor) leaves 0-2.5 CPUs free, so most preemptors need
        # victims
        base[i, 0] = max(base[i, 0], 32000 - rng.choice([0, 1000, 2500]))
    pdb_match = np.zeros((n, v, max(p, 1)), bool)
    pdb_allowed = np.zeros(max(p, 1), np.int32)
    if p:
        pdb_match[..., :p] = (rng.random((n, v, p)) < 0.9) & active[..., None]
        pdb_allowed[:p] = rng.choice([0, 0, 2], p)
    if classes:
        reqs = np.array([[3000, 2 << 20, 0, 1], [8000, 6 << 20, 0, 1],
                         [0, 0, 0, 1]], np.int32)
        pods_req = reqs[rng.integers(0, 3, b)]
        pods_prio = np.sort(rng.choice([20, 40, 60, 90], b))[::-1]
        rows = rng.random((4, n)) > 0.2
        candidate = rows[rng.integers(0, 4, b)]
        # runs of equal pods: sort by (prio desc, request, row)
        order = np.lexsort((candidate[:, 0], pods_req[:, 0], -pods_prio))
        pods_req, pods_prio, candidate = (
            pods_req[order], pods_prio[order], candidate[order]
        )
    else:
        pods_req = np.zeros((b, r), np.int32)
        pods_req[:, 0] = rng.choice([3000, 8000], b)
        pods_req[:, 1] = rng.choice([2, 6], b) << 20
        pods_req[:, 3] = 1
        pods_prio = np.sort(rng.integers(10, 100, b))[::-1]
        candidate = rng.random((b, n)) > 0.2
    nom_req = np.zeros((M_SLOTS, r), np.int32)
    nom_prio = np.full(M_SLOTS, _PRIO_FLOOR, np.int32)
    nom_node = np.full(M_SLOTS, -1, np.int32)
    if m:
        nom_req[:m, 0] = 2000
        nom_req[:m, 3] = 1
        nom_prio[:m] = rng.integers(20, 90, m)
        nom_node[:m] = rng.integers(0, n, m)
    pods_active = np.ones(b, bool)
    pods_active[-2:] = False  # inactive padding tail
    return dict(
        alloc=alloc, base=base, prio=prio, start=start, req=req,
        active=active, pdb_match=pdb_match, pdb_allowed=pdb_allowed, p=p,
        nom_req=nom_req, nom_prio=nom_prio, nom_node=nom_node,
        pods_req=pods_req, pods_prio=pods_prio.astype(np.int32),
        candidate=candidate, pods_active=pods_active,
    )


def _plain(w):
    """The port's plain version on the wave (candidate rows deduplicated);
    returns numpy (chosen, victims [B, V], violating, nviol, state')."""
    rows, index = np.unique(w["candidate"], axis=0, return_inverse=True)
    p = w["p"]
    t = torch.from_numpy
    chosen, vw, ow, nv, state = preempt_kernel.preempt_solve(
        t(w["alloc"]), t(w["base"]), t(w["prio"]), t(w["start"]),
        t(w["req"]), t(w["active"]),
        t(np.ascontiguousarray(w["pdb_match"][..., :p])),
        t(w["pdb_allowed"][:p]), t(w["nom_req"]), t(w["nom_prio"]),
        t(w["nom_node"]), t(w["pods_req"]), t(w["pods_prio"]),
        t(rows), t(index.reshape(-1).astype(np.int32)), t(w["pods_active"]),
    )
    v = w["prio"].shape[1]
    return (
        chosen.numpy(), torch_pre.unpack_bits(vw.numpy(), v),
        torch_pre.unpack_bits(ow.numpy(), v), nv.numpy(), state.numpy(),
    )


def _xla(w):
    chosen, vic, viol, nviol = jax_pre._preempt_batch_kernel(
        w["alloc"], w["base"], w["prio"], w["start"], w["req"], w["active"],
        w["pdb_match"], w["pdb_allowed"], w["nom_req"], w["nom_prio"],
        w["nom_node"], w["pods_req"], w["pods_prio"], w["candidate"],
        w["pods_active"], num_pdbs=w["p"],
    )
    return tuple(np.asarray(a) for a in (chosen, vic, viol, nviol))


def _carry(w, chosen):
    """The post-wave state the nominations imply."""
    state = w["base"].copy()
    for k, c in enumerate(chosen):
        if c >= 0:
            state[c] += w["pods_req"][k]
    return state


@pytest.mark.parametrize("classes", [False, True], ids=["mixed", "classes"])
@pytest.mark.parametrize("p", [0, 3], ids=["no_pdbs", "pdbs"])
@pytest.mark.parametrize("m", [0, 4], ids=["no_noms", "noms"])
@pytest.mark.parametrize("seed", [0, 5])
def test_plain_matches_the_xla_wave_kernel(seed, m, p, classes):
    w = _random_wave(seed, m=m, p=p, classes=classes)
    chosen, vic, viol, nviol, state = _plain(w)
    x_chosen, x_vic, x_viol, x_nviol = _xla(w)
    np.testing.assert_array_equal(chosen, x_chosen)
    np.testing.assert_array_equal(vic, x_vic)
    np.testing.assert_array_equal(viol, x_viol)
    np.testing.assert_array_equal(nviol, x_nviol)
    np.testing.assert_array_equal(state, _carry(w, chosen))
    assert (chosen >= 0).sum() > 0, "the wave must place some preemptors"
    assert (chosen[-2:] == -1).all()  # the inactive tail
    if p:
        assert viol.any() or not w["pdb_match"].any()


@pytest.mark.parametrize("m", [0, 4], ids=["no_noms", "noms"])
@pytest.mark.parametrize("seed", [0, 17])
def test_plain_matches_the_pallas_kernel(seed, m):
    """Interpret-mode Pallas on a wave without PDBs: chosen nodes, victim
    masks and the post-wave carry."""
    w = _random_wave(seed, m=m)
    b = w["pods_req"].shape[0]
    v = w["prio"].shape[1]
    chosen, vic, _, _, state = _plain(w)
    rows, inverse = np.unique(w["candidate"], axis=0, return_inverse=True)
    u_pad = 8 * -(-rows.shape[0] // 8)
    rows_p = np.zeros((u_pad, rows.shape[1]), bool)
    rows_p[: rows.shape[0]] = rows
    active_bits = np.zeros(w["active"].shape[0], dtype=np.int32)
    for vi in range(v):
        active_bits |= w["active"][:, vi].astype(np.int32) << vi
    packed, p_state = pallas_preempt_solve(
        w["alloc"], w["base"], w["prio"], w["start"], w["req"], active_bits,
        w["nom_req"], w["nom_prio"], w["nom_node"],
        w["pods_req"], w["pods_prio"], rows_p,
        inverse.reshape(-1).astype(np.int32), w["pods_active"],
        interpret=True,
    )
    packed = np.asarray(packed)
    bits = packed[1].astype(np.uint32) | (packed[2].astype(np.uint32) << 16)
    p_vic = ((bits[:, None] >> np.arange(v)[None, :]) & 1).astype(bool)
    np.testing.assert_array_equal(chosen, packed[0])
    np.testing.assert_array_equal(vic, p_vic)
    np.testing.assert_array_equal(state, np.asarray(p_state))
    assert b == len(chosen)


def test_bits_round_trip_past_32_victims():
    """K3's result layout: V=48 spans two 32-bit words per pod."""
    rng = np.random.default_rng(3)
    mask = rng.random((5, 48)) < 0.4
    mask[0, 31] = mask[0, 47] = True
    words = torch_pre.pack_bits(torch.from_numpy(mask))
    assert words.dtype == torch.int32 and tuple(words.shape) == (5, 2)
    np.testing.assert_array_equal(
        torch_pre.unpack_bits(words.numpy(), 48), mask
    )


# -- the pack, its upload and the device call, both packages ---------------


def _cluster(mk_node, mk_pod, n_nodes=12, seed=4):
    """A saturated cluster with labelled pods of mixed priority, each
    with a start time (a pod without one counts as the pack's 'now')."""
    rng = random.Random(seed)
    t0 = 1_000_000.0
    nodes, pods = [], []
    for i in range(n_nodes):
        nodes.append(
            mk_node(f"n{i}").capacity(cpu="8", memory="16Gi", pods=20).obj()
        )
        for j in range(rng.randrange(2, 7)):
            p = (
                mk_pod(f"p{i}-{j}").node(f"n{i}")
                .container(cpu=f"{rng.choice([500, 1000, 2000])}m",
                           memory=f"{rng.choice([256, 1024])}Mi")
                .labels(app=rng.choice(["a", "b"]))
                .priority(rng.choice([0, 5, 10])).obj()
            )
            p.status.start_time = t0 + rng.randrange(1000)
            pods.append(p)
    return nodes, pods


def _pdbs(lsel, pdb_cls, budgets=(("a", 1), ("b", 0))):
    out = []
    for app, budget in budgets:
        pdb = pdb_cls(selector=lsel(match_labels={"app": app}))
        pdb.status.disruptions_allowed = budget
        pdb.metadata.name = f"pdb-{app}"
        pdb.metadata.namespace = "default"
        out.append(pdb)
    return out


def _packs():
    jn, jp = _cluster(jax_node, jax_pod)
    tn, tp = _cluster(make_node, make_pod)
    jsnap = jax_new_snapshot(jp, jn)
    tsnap = new_snapshot(tp, tn)
    jnt = JaxNodeTensorCache().update(jsnap)
    tnt = NodeTensorCache().update(tsnap)
    jpack = jax_pre.pack_preemption_state(
        jsnap, jnt, _pdbs(JaxLabelSelector, JaxPDB)
    )
    tpack = torch_pre.pack_preemption_state(
        tsnap, tnt, _pdbs(LabelSelector, PodDisruptionBudget)
    )
    return jpack, tpack


def test_pack_matches_the_jax_pack():
    """One snapshot, both packers: the same node order, per-node victim
    order and tensors. The port's victim axis is exactly the most pods a
    node holds; the JAX package pads it to a power of two with inactive
    slots."""
    jpack, tpack = _packs()
    v = tpack.v_max
    assert v == max(len(p) for p in tpack.pods_by_node)
    assert jpack.v_max >= v
    assert tpack.node_names == jpack.node_names
    assert [[p.metadata.name for p in ps] for ps in tpack.pods_by_node] == [
        [p.metadata.name for p in ps] for ps in jpack.pods_by_node
    ]
    for name in ("alloc", "base_requested", "pdb_allowed"):
        np.testing.assert_array_equal(
            getattr(tpack, name), getattr(jpack, name)
        )
    for name in ("prio", "start_rel", "req", "active", "pdb_match"):
        got, want = getattr(tpack, name), getattr(jpack, name)
        np.testing.assert_array_equal(got, want[:, :v])
    assert not jpack.active[:, v:].any()
    assert torch_pre.pack_num_pdbs(tpack) == jax_pre.pack_num_pdbs(jpack) == 2


def test_uploaded_pack_holds_the_jax_kernel_operands():
    """upload_pack's tensors (one buffer, typed views) are the operands
    the JAX package hands its XLA kernel: clipped int32 priorities, the
    float32 start times, the PDB tensors at the modeled PDB count."""
    jpack, tpack = _packs()
    v = tpack.v_max
    dev = torch_pre.upload_pack(tpack, "cpu")
    assert torch_pre.upload_pack(tpack, "cpu") is dev  # cached per device
    alloc, base, prio, start, req, active, match, allowed = dev
    want_prio = np.clip(jpack.prio, -(1 << 31), (1 << 31) - 2).astype(np.int32)
    np.testing.assert_array_equal(alloc.numpy(), jpack.alloc)
    np.testing.assert_array_equal(base.numpy(), jpack.base_requested)
    np.testing.assert_array_equal(prio.numpy(), want_prio[:, :v])
    assert start.dtype == torch.float32
    np.testing.assert_array_equal(
        start.numpy(), jpack.start_rel.astype(np.float32)[:, :v]
    )
    np.testing.assert_array_equal(req.numpy(), jpack.req[:, :v])
    assert active.dtype == torch.bool and match.dtype == torch.bool
    np.testing.assert_array_equal(active.numpy(), jpack.active[:, :v])
    np.testing.assert_array_equal(match.numpy(), jpack.pdb_match[:, :v, :2])
    np.testing.assert_array_equal(allowed.numpy(), jpack.pdb_allowed)


@pytest.mark.parametrize("noms", [False, True], ids=["no_noms", "noms"])
def test_device_call_matches_the_jax_xla_tier(noms):
    """preempt_batch_device of both packages on their packs of one
    cluster: the port's plain version against the JAX package's XLA tier,
    with PDBs and mixed classes."""
    jpack, tpack = _packs()
    v = tpack.v_max
    n = len(tpack.node_names)
    rng = np.random.default_rng(2)
    b = 10
    pods_req = np.zeros((b, jpack.req.shape[2]), np.int32)
    pods_req[:, 0] = rng.choice([2000, 4000], b)
    pods_req[:, 1] = 512 << 10
    pods_req[:, 3] = 1
    pods_prio = np.sort(rng.choice([6, 20, 100], b))[::-1].astype(np.int32)
    candidate = rng.random((b, n)) > 0.2
    if noms:
        nom_req = pods_req[:3].copy()
        nom_prio = np.array([30, 8, 100], np.int32)
        nom_node = np.array([0, 3, 5], np.int32)
    else:
        nom_req = np.zeros((0, pods_req.shape[1]), np.int32)
        nom_prio = nom_node = np.zeros(0, np.int32)
    want = jax_pre.preempt_batch_device(
        jpack, pods_req, pods_prio, candidate, nom_req, nom_prio, nom_node,
        tier="xla",
    )
    rows, index = np.unique(candidate, axis=0, return_inverse=True)
    got = torch_pre.preempt_batch_device(
        tpack, pods_req, pods_prio, rows, index, nom_req, nom_prio, nom_node,
        device="cpu",
    )
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1][:, :v])
    np.testing.assert_array_equal(got[2], want[2][:, :v])
    np.testing.assert_array_equal(got[3], want[3])
    assert (got[0] >= 0).any()


# -- the Preemptor against the host oracle ---------------------------------


def _env(pods, nodes):
    cache = SchedulerCache()
    for nd in nodes:
        cache.add_node(nd)
    for p in pods:
        cache.add_pod(p)
    snapshot = Snapshot()
    cache.update_snapshot(snapshot)
    algorithm = GenericScheduler(cache, snapshot)
    fw = Framework(
        new_in_tree_registry(),
        default_plugins(),
        snapshot_provider=lambda: snapshot,
    )
    return algorithm, fw


def _fail(algorithm, fw, pod):
    state = CycleState()
    with pytest.raises(FitError) as exc:
        algorithm.schedule(fw, state, pod)
    return state, exc.value


def _random_cluster(rng, with_pdbs):
    """tests/test_preemption_device.py's cluster on the port's types."""
    nodes = []
    for i in range(16):
        w = make_node(f"n{i}").capacity(
            cpu=str(rng.choice([2, 4, 8])), memory="16Gi", pods=32
        )
        if rng.random() < 0.2:
            w.label("disk", "ssd")
        if rng.random() < 0.15:
            w.taint("dedicated", "infra")
        nodes.append(w.obj())
    pods = []
    t0 = time.time() - 10_000
    # near-fill every node so the preemptor always needs victims
    for i, nd in enumerate(nodes):
        cap_milli = nd.status.allocatable["cpu"]
        p = (
            make_pod(f"fill{i}")
            .node(nd.metadata.name)
            .container(cpu=f"{cap_milli - 1000}m", memory="8Gi")
            .labels(app=rng.choice(["a", "b", "c"]))
            .priority(rng.choice([0, 5]))
            .obj()
        )
        p.status.start_time = t0 + rng.randrange(10_000)
        pods.append(p)
    for j in range(40):
        node = f"n{rng.randrange(16)}"
        p = (
            make_pod(f"p{j}")
            .node(node)
            .container(
                cpu=f"{rng.choice([250, 500, 1000, 2000])}m",
                memory=f"{rng.choice([128, 512, 1024])}Mi",
            )
            .labels(app=rng.choice(["a", "b", "c"]))
            .priority(rng.choice([0, 0, 5, 10, 50]))
            .obj()
        )
        p.status.start_time = t0 + rng.randrange(10_000)
        pods.append(p)
    pdbs = _pdbs(LabelSelector, PodDisruptionBudget) if with_pdbs else []
    return nodes, pods, pdbs


def _host_answer(preemptor, prof, state, pod, fit_err, pdbs):
    """The oracle: per-node select_victims + 6-rule pick."""
    potential = preemptor.nodes_where_preemption_might_help(fit_err)
    nodes_to_victims = {}
    for ni in potential:
        victims, num_violating, fits = preemptor.select_victims_on_node(
            prof, state, pod, ni, pdbs
        )
        if fits:
            nodes_to_victims[ni.node_name] = Victims(victims, num_violating)
    node = pick_one_node_for_preemption(nodes_to_victims)
    if node is None:
        return "", set()
    return node, {p.metadata.name for p in nodes_to_victims[node].pods}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_pdbs", [False, True])
def test_device_search_matches_the_host_oracle(seed, with_pdbs):
    rng = random.Random(seed)
    nodes, pods, pdbs = _random_cluster(rng, with_pdbs)
    algorithm, fw = _env(pods, nodes)
    preemptor = Preemptor(algorithm, None, None, device="cpu")
    preemptor_pod = (
        make_pod("preemptor").container(cpu="2", memory="4Gi")
        .priority(100).obj()
    )
    if rng.random() < 0.5:
        preemptor_pod.spec.node_selector["disk"] = "ssd"
    state, fit_err = _fail(algorithm, fw, preemptor_pod)

    assert preemptor.device_eligible(fw, preemptor_pod)
    dev, tier = preemptor._find_preemption_device(
        preemptor_pod,
        preemptor.nodes_where_preemption_might_help(fit_err),
        pdbs,
    )
    assert dev is not None and tier == "torch"
    dev_node, dev_victims, _ = dev
    host_node, host_victims = _host_answer(
        preemptor, fw, state, preemptor_pod, fit_err, pdbs
    )
    assert dev_node == host_node
    assert {p.metadata.name for p in dev_victims} == host_victims


def test_pdb_budget_ordering_matches_the_host_oracle():
    """Victims protected by an exhausted PDB go violating-first through
    reprieve, matching filterPodsWithPDBViolation + the reprieve order."""
    rng = random.Random(99)
    nodes, pods, pdbs = _random_cluster(rng, True)
    # park every pod on one node so PDB budgets really contend
    for p in pods[:20]:
        p.spec.node_name = "n0"
    nodes[0].status.allocatable["cpu"] = 64000
    nodes[0].status.capacity["cpu"] = 64000
    nodes[0].status.allocatable["memory"] = 128 * 1024**3
    algorithm, fw = _env(pods, nodes)
    preemptor = Preemptor(algorithm, None, None, device="cpu")
    preemptor_pod = (
        make_pod("preemptor").container(cpu="60", memory="100Gi")
        .priority(100).obj()
    )
    state, fit_err = _fail(algorithm, fw, preemptor_pod)
    dev, _tier = preemptor._find_preemption_device(
        preemptor_pod,
        preemptor.nodes_where_preemption_might_help(fit_err),
        pdbs,
    )
    host_node, host_victims = _host_answer(
        preemptor, fw, state, preemptor_pod, fit_err, pdbs
    )
    assert dev is not None
    assert dev[0] == host_node
    assert {p.metadata.name for p in dev[1]} == host_victims
    assert dev[2] > 0  # the exhausted budget made violating victims


def test_preemptor_defaults_to_the_card():
    """The victim search runs on the card unless the CPU is named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default is valid")
    algorithm, _ = _env([], [])
    with pytest.raises(RuntimeError, match="CUDA"):
        Preemptor(algorithm, None, None)
