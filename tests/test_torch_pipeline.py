"""The speculative pipeline and the resident carry, on the CPU, in both
packages.

Twins of ``tests/test_speculative_pipeline.py`` and ``tests/
test_state_uploads_guard.py``: each scenario runs through the JAX
package's batch scheduler and through the port's (``device="cpu"``), and
both are held to the reference's contract. Placements are equal pod for
pod across the packages and to the port's sequential oracle
(``batch=False``, the first candidate kept on a tie).

- A 1k-pod burst with each commit held on the committer thread until
  the next batch has been dispatched (at most ``HOLD_MAX`` seconds), so
  batch N+1's solve launches on the shadow expectation while batch N
  commits: no carry divergence, no rewind, and speculation happened. The
  reference holds each commit a fixed 30 ms; the port's plain solve runs
  inside the dispatch on the CPU (tens of ms for 128 pods, more on a
  loaded box), where the JAX package's dispatch returns before its
  solve ends, so a fixed hold would not make either package's
  speculation certain.
- One injected bind conflict: every pod binds, the rewinds stay within
  ``max_inflight + 2``, every uid binds exactly once in the watch
  history, and both packages book the rewind under the same reasons.
- The int16 carry at the reference's shape (40 nodes of 4 CPU / 24Mi,
  max_batch 16): compressed and int32 (``KTPU_CARRY_COMPRESS=0``) place
  alike and as the oracle; the gate engaged, then disengaged by range as
  the carry filled.
- A steady 1k-pod burst and a burst under node churn do at most one
  full node-state upload, with no divergence and no double bind.
"""

import random
import time

import pytest

import kubernetes_tpu.robustness.faults as jax_faults
import kubernetes_tpu_torch.robustness.faults as port_faults
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu.utils import metrics as jax_metrics
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.utils import metrics as port_metrics

from test_torch_slice import _bind_transitions_by_uid

PKG = {
    "jax": dict(server=JaxAPIServer, client=JaxClient, informers=JaxInformers,
                new=jax_new, node=jax_node, pod=jax_pod, faults=jax_faults,
                metrics=jax_metrics, kw={}),
    "torch": dict(server=APIServer, client=Client, informers=InformerFactory,
                  new=new_scheduler, node=make_node, pod=make_pod,
                  faults=port_faults, metrics=port_metrics,
                  kw={"device": "cpu"}),
}
BOTH = ("jax", "torch")
REWIND_REASONS = ("row_patch", "mirror_wait", "drain")
#: the longest a commit waits on the committer thread for the next
#: dispatch (see above)
HOLD_MAX = 1.0


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    for pkg in BOTH:
        PKG[pkg]["faults"].install_injector(None)


class _KeepFirstRng:
    """The sequential oracle keeps the first of tied nodes: the device
    argmax's lowest index."""

    def randrange(self, n):
        return 1 if n > 1 else 0

    def randint(self, a, b):
        return b


def _specs(num, seed, prefix, cpus=(100, 200, 250), mems=("128Mi", "256Mi")):
    rng = random.Random(seed)
    return [
        (f"{prefix}{i}", f"{rng.choice(cpus)}m", rng.choice(mems))
        for i in range(num)
    ]


def _run(pkg, specs, *, batch=True, nodes=16, node_cpu="64",
         node_mem="256Gi", max_pods=200, max_batch=128, chunk=128,
         slow_commit=0.0, await_next=False, timeout=120.0):
    """The reference guard's harness in package ``pkg``: nodes, then the
    pods in chunks (several batches in flight), each commit held
    ``slow_commit`` seconds on the committer thread, or (``await_next``)
    until the next batch has been dispatched, so the dispatcher gets
    ahead. Returns (placements, scheduler, server)."""
    P = PKG[pkg]
    server = P["server"]()
    client = P["client"](server)
    informers = P["informers"](server)
    sched = P["new"](client, informers, batch=batch, max_batch=max_batch,
                     rng=_KeepFirstRng(), **P["kw"])
    if batch and (slow_commit or await_next):
        orig = sched._complete_solve

        def held(p, _orig=orig):
            time.sleep(slow_commit)
            deadline = time.time() + HOLD_MAX
            while (await_next and len(sched._pending_q) < 2
                   and time.time() < deadline):
                time.sleep(0.002)
            _orig(p)

        sched._complete_solve = held
    for i in range(nodes):
        client.create_node(
            P["node"](f"g{i}")
            .capacity(cpu=node_cpu, memory=node_mem, pods=max_pods).obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.start()
    try:
        pods = [
            P["pod"](name).creation_timestamp(float(i))
            .container(cpu=cpu, memory=mem).obj()
            for i, (name, cpu, mem) in enumerate(specs)
        ]
        for lo in range(0, len(pods), chunk):
            client.create_pods_bulk(pods[lo:lo + chunk])
        deadline = time.time() + timeout
        while time.time() < deadline:
            if sum(1 for p in client.list_pods()[0] if p.spec.node_name) \
                    >= len(pods):
                break
            time.sleep(0.05)
        sched.wait_for_inflight_binds()
        placements = {
            p.metadata.name: p.spec.node_name for p in client.list_pods()[0]
        }
        return placements, sched, server
    finally:
        sched.stop()
        informers.stop()


def _rewinds_by_reason(pkg):
    counter = PKG[pkg]["metrics"].speculative_rewinds
    return {r: counter.value(reason=r) for r in REWIND_REASONS}


def test_speculative_burst_places_as_the_oracle_and_the_jax_package():
    specs = _specs(1000, 42, "s")
    want, _, _ = _run("torch", specs, batch=False)
    assert all(want.values()), "the oracle left a fitting pod unplaced"
    for pkg in BOTH:
        got, sched, _ = _run(pkg, specs, await_next=True)
        assert got == want, pkg
        assert sched.pods_fallback == 0
        assert sched.pods_solved_on_device == 1000
        assert sched.carry_divergences == 0, pkg
        assert sched.speculative_launches > 0, f"{pkg}: the burst ran serially"
        assert sched.speculative_rewinds == 0, pkg


def test_one_bind_conflict_rewinds_bounded_and_binds_exactly_once():
    specs = _specs(600, 7, "s")
    reasons = {}
    for pkg in BOTH:
        P = PKG[pkg]
        point = P["faults"].FaultPoint.BIND_CONFLICT
        P["faults"].install_injector(P["faults"].FaultInjector(
            P["faults"].FaultProfile(
                "spec-one-conflict", seed=0,
                points={point: P["faults"].PointConfig(rate=1.0,
                                                       max_fires=1)},
            )
        ))
        fired = P["metrics"].faults_injected.value(point=point)
        before = _rewinds_by_reason(pkg)
        got, sched, server = _run(pkg, specs, max_batch=64,
                                 await_next=True)
        P["faults"].install_injector(None)
        assert all(got.values()), (
            f"{pkg}: unbound after the conflict: "
            f"{[k for k, v in got.items() if not v][:5]}"
        )
        assert P["metrics"].faults_injected.value(point=point) > fired, (
            f"{pkg}: the conflict never fired"
        )
        assert sched.speculative_rewinds <= sched.max_inflight + 2, (
            f"{pkg}: {sched.speculative_rewinds} rewinds from one conflict"
        )
        transitions = _bind_transitions_by_uid(server)
        assert len(transitions) == len(specs), pkg
        assert all(c == 1 for c in transitions.values()), pkg
        after = _rewinds_by_reason(pkg)
        moved = {r: after[r] - before[r] for r in REWIND_REASONS}
        assert sum(moved.values()) == sched.speculative_rewinds, pkg
        assert sched.speculative_launches > 0, pkg
        reasons[pkg] = {r for r, k in moved.items() if k}
    assert reasons["torch"] == reasons["jax"]


def _small_unit_specs(num, seed):
    """1Mi a pod at most: 24 pods fill a 24Mi node at exactly the int16
    gate's 24,576 KiB ceiling."""
    rng = random.Random(seed)
    return [
        (f"c{i}", f"{rng.choice((50, 100, 150))}m",
         f"{rng.choice((512, 1024))}Ki")
        for i in range(num)
    ]


def test_int16_carry_places_as_int32_the_oracle_and_the_jax_package(
    monkeypatch,
):
    specs = _small_unit_specs(300, 11)
    shape = dict(nodes=40, node_cpu="4", node_mem="24Mi")
    want, _, _ = _run("torch", specs, batch=False, **shape)
    assert all(want.values())
    for pkg in BOTH:
        m = PKG[pkg]["metrics"]
        runs = {}
        for flag in ("1", "0"):
            monkeypatch.setenv("KTPU_CARRY_COMPRESS", flag)
            saved = m.carry_compress_bytes_saved.value()
            ranged = m.carry_compress_disengages.value(reason="range")
            got, sched, _ = _run(pkg, specs, max_batch=16, slow_commit=0.01,
                                 **shape)
            runs[flag] = dict(
                got=got, sched=sched,
                saved=m.carry_compress_bytes_saved.value() - saved,
                ranged=m.carry_compress_disengages.value(reason="range")
                - ranged,
            )
        on, off = runs["1"], runs["0"]
        assert on["sched"].carry_compress_enabled
        assert not off["sched"].carry_compress_enabled
        assert on["got"] == want, f"{pkg}: the int16 carry diverged"
        assert off["got"] == want, f"{pkg}: the int32 carry diverged"
        assert on["sched"].carry_divergences == 0
        assert on["sched"].pods_fallback == 0
        # the gate engaged (bytes kept off the link), then the filling
        # carry left its range
        assert on["saved"] > 0, pkg
        assert on["ranged"] > 0, pkg
        assert off["saved"] == 0 and off["ranged"] == 0, pkg


def test_steady_burst_uploads_the_node_state_once():
    specs = _specs(1000, 42, "b")
    shape = dict(max_pods=120, max_batch=256, chunk=1000)
    want, _, _ = _run("torch", specs, batch=False, **shape)
    assert all(want.values())
    for pkg in BOTH:
        got, sched, _ = _run(pkg, specs, **shape)
        assert got == want, pkg
        assert sched.pods_fallback == 0
        assert sched.pods_solved_on_device == 1000
        assert sched.batches_solved >= 2, pkg
        assert sched.state_uploads <= 1, (
            f"{pkg}: {sched.state_uploads} uploads for "
            f"{sched.batches_solved} batches"
        )
        assert sched.state_reuses >= sched.batches_solved - 1
        assert sched.carry_divergences == 0


def _churn_burst(pkg):
    """The reference's churn guard: 38 nodes, a 500-pod wave, 2 cold
    nodes and 2 cordoned flaps join, 250 pods, the flaps retire, 250
    more."""
    P = PKG[pkg]
    rng = random.Random(7)
    server = P["server"]()
    client = P["client"](server)
    informers = P["informers"](server)
    sched = P["new"](client, informers, batch=True, max_batch=256,
                     rng=_KeepFirstRng(), **P["kw"])

    def node(name, cordoned=False):
        w = P["node"](name).capacity(cpu="64", memory="256Gi", pods=120)
        client.create_node((w.unschedulable() if cordoned else w).obj())

    def wave(lo, hi):
        for i in range(lo, hi):
            client.create_pod(
                P["pod"](f"b{i}").creation_timestamp(float(i)).container(
                    cpu=f"{rng.choice([100, 200, 250])}m",
                    memory=f"{rng.choice([128, 256])}Mi",
                ).obj()
            )
        deadline = time.time() + 120
        while time.time() < deadline:
            if sum(1 for p in client.list_pods()[0] if p.spec.node_name) >= hi:
                return
            time.sleep(0.05)
        raise AssertionError(f"{pkg}: fewer than {hi} pods bound")

    for i in range(38):
        node(f"g{i}")
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.start()
    try:
        wave(0, 500)
        for name in ("cold-0", "cold-1"):
            node(name)
        for name in ("flap-0", "flap-1"):
            node(name, cordoned=True)
        wave(500, 750)
        client.delete_node("flap-0")
        client.delete_node("flap-1")
        wave(750, 1000)
        sched.wait_for_inflight_binds()
        placements = {
            p.metadata.name: p.spec.node_name for p in client.list_pods()[0]
        }
        return placements, sched, server
    finally:
        sched.stop()
        informers.stop()


def test_churn_burst_uploads_once_and_never_binds_twice():
    results = {}
    for pkg in BOTH:
        placements, sched, server = _churn_burst(pkg)
        assert all(placements.values()), pkg
        assert any(n in ("cold-0", "cold-1") for n in placements.values())
        assert sched.state_uploads <= 1, pkg
        assert sched.carry_divergences == 0
        assert sched.membership_row_patches >= 4
        tc = sched.tensor_cache
        assert (tc.full_repacks, tc.rows_added, tc.rows_retired) == (1, 4, 2)
        assert sched.pods_fallback == 0
        assert sched.batches_solved >= 3
        transitions = _bind_transitions_by_uid(server)
        assert all(c == 1 for c in transitions.values()), pkg
        results[pkg] = placements
    assert results["torch"] == results["jax"]
