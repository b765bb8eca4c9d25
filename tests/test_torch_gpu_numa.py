"""GPU bin-packing and single-NUMA alignment (BASELINE config #4), on the
CPU, in both packages.

Twins of ``tests/test_numa.py`` (the NodeResourcesNumaAligned plugin's
Filter on fragmented and unlabeled nodes, and end to end: no NUMA group
over its size, a pod that cannot align left pending, a fragmented node
passed over for one with a whole free group), each through the JAX
package and the port (``device="cpu"``) on identical inputs. Aligned
pods take the sequential path by admission, whose tie-break draws from
``rng``: both packages get ``random.Random`` at the same seed, so they
must place alike.

A GPUBinPack miniature (``nvidia.com/gpu`` as the fifth resource column,
scoring weights least 0, balanced 0, most 1) runs through both batch
schedulers, and each solve the port made is solved again by the JAX
package's ``solve_packed`` from the same packed pieces and handed state:
assignments, requested' and nzr' equal bit for bit, and the resident
carries of the two schedulers equal at the end. A mixed burst of aligned
and unaligned GPU pods interleaves batch solves with host binds: equal
placements and an equal ``pods_fallback``. Tolerance: exact.
"""

import random
import time

import numpy as np

from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.cache.node_info import NodeInfo as JaxNodeInfo
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.framework.interface import CycleState as JaxCycleState
from kubernetes_tpu.ops import assignment as jax_asg
from kubernetes_tpu.plugins import numa as jax_numa
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.framework.interface import CycleState
from kubernetes_tpu_torch.ops import assignment as torch_asg
from kubernetes_tpu_torch.plugins import numa as torch_numa
from kubernetes_tpu_torch.scheduler import batch as torch_batch
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

PKG = {
    "jax": dict(server=JaxAPIServer, client=JaxClient, informers=JaxInformers,
                new=jax_new, node=jax_node, pod=jax_pod, numa=jax_numa,
                node_info=JaxNodeInfo, state=JaxCycleState,
                config=jax_asg.GreedyConfig, kw={}),
    "torch": dict(server=APIServer, client=Client, informers=InformerFactory,
                  new=new_scheduler, node=make_node, pod=make_pod,
                  numa=torch_numa, node_info=NodeInfo, state=CycleState,
                  config=torch_asg.GreedyConfig, kw={"device": "cpu"}),
}
BIN_PACK = (0, 0, 1)  # least, balanced, most: performance-config.yaml:210-212


def gpu_pod(P, name, gpus, aligned=True):
    w = P["pod"](name).container(
        cpu="100m", memory="128Mi", **{"nvidia_com__gpu": gpus})
    if aligned:
        w.pod.metadata.annotations[P["numa"].ALIGNED_ANNOTATION] = (
            "nvidia.com/gpu")
    return w.obj()


def gpu_node(P, name, groups="4_4", pods=20):
    nw = P["node"](name).capacity(
        cpu="32", memory="64Gi", pods=pods, **{"nvidia_com__gpu": 8})
    if groups:
        nw.label(P["numa"].GROUPS_LABEL, groups)
    return nw.obj()


def run(pkg, nodes, pods, *, max_batch=64, seed=0, solver=None, until=None,
        timeout=60.0, hook=None):
    """``pods`` through package ``pkg``'s batch scheduler on ``nodes``
    (built by ``nodes(P)`` and ``pods(P)``); returns (placements, the
    scheduler, every pod at the end). Waits until every created pod is
    bound or carries a condition, or until ``until(client)``."""
    P = PKG[pkg]
    server = P["server"]()
    client = P["client"](server)
    informers = P["informers"](server)
    config = P["config"](*solver) if solver else None
    sched = P["new"](client, informers, batch=True, max_batch=max_batch,
                     rng=random.Random(seed), solver_config=config,
                     **P["kw"])
    for n in nodes(P):
        client.create_node(n)
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    made = pods(P)
    for p in made:
        client.create_pod(p)
    queued = sum(1 for p in made if not p.spec.node_name)
    deadline = time.time() + 10
    while (sched.queue.num_pending()["active"] < queued
           and time.time() < deadline):
        time.sleep(0.01)
    undo = hook(sched) if hook else None
    sched.start()
    try:
        deadline = time.time() + timeout
        while True:
            cur, _ = client.list_pods()
            if until is not None and until(client):
                break
            if until is None and all(
                p.spec.node_name or p.status.conditions for p in cur
            ):
                break
            if time.time() > deadline:
                raise AssertionError(f"{pkg}: pods not decided in time")
            time.sleep(0.05)
        sched.wait_for_inflight_binds()
        every = client.list_pods()[0]
        return {p.metadata.name: p.spec.node_name for p in every}, sched, every
    finally:
        sched.stop()
        informers.stop()
        if undo:
            undo()


def group_usage(P, pods):
    """GPUs held per (node, NUMA group) by aligned pods."""
    usage = {}
    for p in pods:
        g = p.metadata.annotations.get(P["numa"].ASSIGNED_ANNOTATION)
        if p.spec.node_name and g is not None:
            key = (p.spec.node_name, g)
            usage[key] = usage.get(key, 0) + int(
                p.spec.containers[0].resources.requests["nvidia.com/gpu"])
    return usage


# -- tests/test_numa.py: the plugin ------------------------------------------


def filter_verdicts(P, groups, held, want):
    """The plugin's Filter on one node whose groups hold ``held`` (group
    -> GPUs) for an aligned and an unaligned pod, and the free count per
    group."""
    node = gpu_node(P, "n", groups=groups)
    ni = P["node_info"](node)
    for g, gpus in held.items():
        p = gpu_pod(P, f"held{g}", gpus)
        p.metadata.annotations[P["numa"].ASSIGNED_ANNOTATION] = str(g)
        ni.add_pod(p)
    plugin = P["numa"].NodeResourcesNumaAligned()

    def verdict(st):
        return None if st is None else (st.is_success(), st.code)

    return (
        P["numa"].group_free(ni, "nvidia.com/gpu"),
        verdict(plugin.filter(P["state"](), gpu_pod(P, "w", want), ni)),
        verdict(plugin.filter(P["state"](), gpu_pod(P, "w2", want,
                                                    aligned=False), ni)),
    )


def test_filter_rejects_fragmented_groups():
    got, want = (filter_verdicts(PKG[k], "4_4", {0: 3, 1: 3}, 2)
                 for k in ("torch", "jax"))
    assert got == want
    free, aligned, unaligned = got
    assert free == [1, 1]  # no group fits 2
    assert aligned is not None and not aligned[0]
    assert unaligned is None  # an unaligned pod is untouched


def test_filter_rejects_unlabeled_node():
    got, want = (filter_verdicts(PKG[k], "", {}, 2) for k in ("torch", "jax"))
    assert got == want
    free, aligned, _ = got
    assert free is None and aligned is not None and not aligned[0]


# -- tests/test_numa.py: end to end ------------------------------------------


def test_group_capacity_never_exceeded():
    """24 aligned 2-GPU pods exactly fill 6 nodes x 2 groups x 4 GPUs."""
    def nodes(P):
        return [gpu_node(P, f"n{i}") for i in range(6)]

    def pods(P):
        return [gpu_pod(P, f"g{i}", 2) for i in range(24)]

    got, sched, every = run("torch", nodes, pods, seed=3)
    want, jsched, _ = run("jax", nodes, pods, seed=3)
    assert got == want
    assert sum(1 for n in got.values() if n) == 24
    usage = group_usage(PKG["torch"], every)
    assert all(v <= 4 for v in usage.values()), usage
    assert sched.pods_fallback == jsched.pods_fallback == 24


def test_misaligned_excess_pod_stays_pending():
    """On a 3_5 node a 5-GPU pod aligns to group 1; a 4-GPU pod after it
    cannot align and stays pending with PodScheduled=False."""
    def outcome(pkg):
        P = PKG[pkg]

        def second_decided(client):
            p = client.get_pod("default", "second")
            return p.spec.node_name or any(
                c.type == "PodScheduled" and c.status == "False"
                for c in p.status.conditions)

        def make(P):
            return [gpu_pod(P, "big", 5), gpu_pod(P, "second", 4)]

        got, _, every = run(pkg, lambda P: [gpu_node(P, "only", "3_5")],
                            make, until=second_decided)
        groups = {p.metadata.name: p.metadata.annotations.get(
            P["numa"].ASSIGNED_ANNOTATION) for p in every}
        return got, groups

    got, want = outcome("torch"), outcome("jax")
    assert got == want
    placed, groups = got
    assert placed == {"big": "only", "second": ""}
    assert groups["big"] == "1"


def test_fragmented_node_rejected_despite_total_capacity():
    """Two GPUs free on "frag" (one in each group) would fit a 2-GPU pod
    by count; only the NUMA filter sends it to "roomy", group 1."""
    def nodes(P):
        return [gpu_node(P, "frag"), gpu_node(P, "roomy")]

    def pods(P):
        out = []
        for node, g, gpus in (("frag", 0, 3), ("frag", 1, 3), ("roomy", 0, 4)):
            p = gpu_pod(P, f"h-{node}-{g}", gpus)
            p.spec.node_name = node
            p.metadata.annotations[P["numa"].ASSIGNED_ANNOTATION] = str(g)
            out.append(p)
        return out + [gpu_pod(P, "want2", 2)]

    def outcome(pkg):
        got, _, every = run(pkg, nodes, pods)
        w = next(p for p in every if p.metadata.name == "want2")
        return got, w.metadata.annotations.get(
            PKG[pkg]["numa"].ASSIGNED_ANNOTATION)

    got, want = outcome("torch"), outcome("jax")
    assert got == want
    assert got[0]["want2"] == "roomy" and got[1] == "1"


# -- GPUBinPack: K1's batch at R = 5 with the bin-packing weights -------------


def record_solves(calls):
    """Wrap the port's batch solve to record each solve's pieces, handed
    state and answer; returns the undo."""
    orig = torch_batch.solve_packed

    def recording(pieces, alloc_in, valid_in, req_in, nzr_in, **kw):
        pieces = [(n, a.copy() if isinstance(a, np.ndarray) else a)
                  for n, a in pieces]
        handed = [None if t is None else t.clone()
                  for t in (alloc_in, valid_in, req_in, nzr_in)]
        out = orig(pieces, alloc_in, valid_in, req_in, nzr_in, **kw)
        calls.append((pieces, handed, kw, [t.clone() for t in out[:3]]))
        return out

    torch_batch.solve_packed = recording
    return lambda: setattr(torch_batch, "solve_packed", orig)


def test_gpu_bin_pack_matches_the_jax_solve():
    """GPUBinPack/500 in miniature: 24 nodes of 8 GPUs (some carrying a
    GPU pod already), 90 one-GPU pods in batches of 32, most-allocated
    scoring only. Each of the port's solves equals the JAX package's
    solve_packed on the same pieces and state; the placements, the
    resident carries and the nodes used equal the JAX scheduler's, and
    the pods pack 8 to a node."""
    def nodes(P):
        return [gpu_node(P, f"n{i:02d}", groups=None, pods=110)
                for i in range(24)]

    def pods(P):
        out = []
        for i in range(4):  # pre-bound GPU pods: uneven starting load
            p = gpu_pod(P, f"pre{i}", 1 + i, aligned=False)
            p.spec.node_name = f"n{5 * i + 3:02d}"
            out.append(p)
        return out + [gpu_pod(P, f"gpu{i:02d}", 1, aligned=False)
                      for i in range(90)]

    calls = []
    got, sched, every = run("torch", nodes, pods, max_batch=32,
                            solver=BIN_PACK,
                            hook=lambda s: record_solves(calls))
    want, jsched, _ = run("jax", nodes, pods, max_batch=32, solver=BIN_PACK)
    assert got == want
    assert calls and sched.pods_fallback == jsched.pods_fallback == 0
    jcfg = jax_asg.GreedyConfig(*BIN_PACK)
    for pieces, handed, kw, out in calls:
        assert dict(pieces)["req"].shape[1] == 5  # nvidia.com/gpu column
        assert kw["config"] == torch_asg.GreedyConfig(*BIN_PACK)
        ref = jax_asg.solve_packed(
            pieces, *[None if t is None else t.numpy() for t in handed],
            config=jcfg, mode=kw.get("mode", "greedy"))
        for g, w in zip(out, ref[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the post-batch carry: the resident state of both schedulers
    for a, b in ((sched._dev.req_dev, jsched._dev.req_dev),
                 (sched._dev.nzr_dev, jsched._dev.nzr_dev)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    per_node = {}
    for p in every:
        if p.spec.node_name:
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name, 0) + (
                int(p.spec.containers[0].resources.requests["nvidia.com/gpu"]))
    assert max(per_node.values()) == 8  # bin-packed to the node's GPUs


# -- the mixed burst: batch solves and host binds interleaved ----------------


def test_mixed_aligned_burst_matches_the_jax_package():
    """20 nodes of 8 GPUs in groups 4_4; 60 pods, every other one asking
    two GPUs aligned to a group (the sequential path), the rest one GPU
    unaligned (the batch solve), in batches of 16. With the tie-break
    seeded alike both packages place every pod alike and send the same
    pods down the sequential path; no group holds more aligned GPUs than
    its size and no node more than 8."""
    def nodes(P):
        return [gpu_node(P, f"n{i:02d}") for i in range(20)]

    def pods(P):
        return [gpu_pod(P, f"p{i:02d}", 2 if i % 2 == 0 else 1,
                        aligned=i % 2 == 0) for i in range(60)]

    got, sched, every = run("torch", nodes, pods, max_batch=16, seed=99,
                            solver=BIN_PACK)
    want, jsched, _ = run("jax", nodes, pods, max_batch=16, seed=99,
                          solver=BIN_PACK)
    assert got == want
    assert all(got.values())
    assert sched.pods_fallback == jsched.pods_fallback == 30
    assert sched.gang_resolves == jsched.gang_resolves == 0
    usage = group_usage(PKG["torch"], every)
    assert all(v <= 4 for v in usage.values()), usage
    per_node = {}
    for p in every:
        per_node[p.spec.node_name] = per_node.get(p.spec.node_name, 0) + int(
            p.spec.containers[0].resources.requests["nvidia.com/gpu"])
    assert max(per_node.values()) <= 8
