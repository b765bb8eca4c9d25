"""The port's main path as a whole, on the CPU, against the JAX package.

The same seeded cluster and burst go through the JAX package's batch
scheduler and through the port's (``new_scheduler(batch=True,
device="cpu")``): every pod binds, and the placements are equal pod for
pod -- for plain pods (the greedy solve) and for one constrained burst
per family on a zoned cluster: hard zone spread, hostname
anti-affinity, zone affinity, preferred affinity on a cluster whose
existing pods score every batch, and a Service's selector spread (the
constrained solve). And no module of the port imports JAX or the JAX
package.
"""

import ast
import os
import random
import time

import pytest

from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kubernetes_tpu_torch")
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"

STACKS = {
    "jax": (JaxAPIServer, JaxClient, JaxInformers, jax_new, jax_node, jax_pod),
    "torch": (APIServer, Client, InformerFactory, new_scheduler, make_node,
              make_pod),
}


def _pod_specs(num, seed):
    rng = random.Random(seed)
    return [
        (f"p{i}", f"{rng.choice((100, 250, 500, 1000))}m",
         f"{rng.choice((128, 256, 512, 1024))}Mi")
        for i in range(num)
    ]


def _wait_bound(client, want, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        pods, _ = client.list_pods()
        if sum(1 for p in pods if p.spec.node_name) >= want:
            return
        time.sleep(0.05)


def _service(stack, name, selector):
    if stack == "jax":
        from kubernetes_tpu.api.types import ObjectMeta, Service
    else:
        from kubernetes_tpu_torch.api.types import ObjectMeta, Service
    return Service(
        metadata=ObjectMeta(name=name, namespace="default"),
        selector=dict(selector),
    )


def _run(stack, specs, nodes=64, max_batch=128, extra=None, caps=None,
         zones=0, labels=None, services=(), **kw):
    Server, Cl, Informers, new, mk_node, mk_pod = STACKS[stack]
    server = Server()
    client = Cl(server)
    informers = Informers(server)
    sched = new(client, informers, batch=True, max_batch=max_batch, **kw)
    rng = random.Random(1)
    for i in range(nodes):
        cpu, mem = caps or (
            str(rng.choice((4, 8, 16))), f"{rng.choice((8, 16, 32))}Gi"
        )
        node = (
            mk_node(f"n{i}")
            .capacity(cpu=cpu, memory=mem, pods=110)
            .label(HOST, f"n{i}")
        )
        if zones:
            node = node.label(ZONE, f"zone-{i % zones}")
        client.create_node(node.obj())
    for name, selector in services:
        server.create(_service(stack, name, selector))
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.start()
    try:
        pods = [
            mk_pod(name).creation_timestamp(float(i))
            .container(cpu=cpu, memory=mem).labels(**(labels or {})).obj()
            for i, (name, cpu, mem) in enumerate(specs)
        ]
        for lo in range(0, len(pods), 100):
            client.create_pods_bulk(pods[lo:lo + 100])
        _wait_bound(client, len(pods))
        sched.wait_for_inflight_binds()
        if extra is not None:
            extra(client, mk_pod)
        placements = {
            p.metadata.name: p.spec.node_name for p in client.list_pods()[0]
        }
        return placements, sched
    finally:
        sched.stop()
        informers.stop()


def test_plain_burst_places_like_the_jax_package():
    specs = _pod_specs(300, seed=5)
    want, _ = _run("jax", specs)
    got, sched = _run("torch", specs, device="cpu")
    assert all(got.values()), [k for k, v in got.items() if not v][:5]
    assert got == want
    assert sched.pods_fallback == 0
    tiers = sched.ladder.solves_by_tier
    assert tiers["torch"] > 0
    assert tiers["cuda"] == tiers["host_greedy"] == tiers["sequential"] == 0


def test_int16_carry_burst_places_like_the_jax_package():
    """A cluster whose per-node KiB/milliCPU totals sit inside the int16
    range gate: the resident carry runs compressed (packed 'h' uploads,
    int16 on the device, mode flips as it fills) and still places pod
    for pod like the JAX package."""
    from kubernetes_tpu_torch.utils import metrics

    rng = random.Random(11)
    specs = [
        (f"c{i}", f"{rng.choice((50, 100, 150))}m",
         f"{rng.choice((512, 1024))}Ki")
        for i in range(300)
    ]
    kw = dict(nodes=40, max_batch=16, caps=("4", "24Mi"))
    want, _ = _run("jax", specs, **kw)
    saved = metrics.carry_compress_bytes_saved.value()
    got, sched = _run("torch", specs, device="cpu", **kw)
    assert all(got.values())
    assert got == want
    assert metrics.carry_compress_bytes_saved.value() > saved
    assert sched.pods_fallback == 0


def test_required_anti_affinity_takes_the_sequential_route():
    """Pods with required anti-affinity need the constrained solve. The
    port no longer routes their batch to the sequential path: it solves
    on the ``torch`` tier (the constrained kernel's plain version on the
    CPU), the pods land on distinct nodes, and every pod places as in the
    JAX package."""
    n_anti = 4

    def anti_batch(client, mk_pod):
        client.create_pods_bulk([
            mk_pod(f"anti{i}").labels(app="db")
            .creation_timestamp(100.0 + i)
            .container(cpu="100m", memory="64Mi")
            .pod_affinity(
                "kubernetes.io/hostname", {"app": "db"}, anti=True
            ).obj()
            for i in range(n_anti)
        ])
        _wait_bound(client, 40 + n_anti)

    run = dict(nodes=8, extra=anti_batch)
    want, _ = _run("jax", _pod_specs(40, seed=6), **run)
    placements, sched = _run(
        "torch", _pod_specs(40, seed=6), device="cpu", **run
    )
    assert all(placements.values())
    hosts = [placements[f"anti{i}"] for i in range(n_anti)]
    assert len(set(hosts)) == n_anti
    assert placements == want
    assert sched.pods_fallback == 0
    tiers = sched.ladder.solves_by_tier
    assert tiers["torch"] > 0
    assert tiers["cuda"] == tiers["host_greedy"] == tiers["sequential"] == 0


def _family_burst(family):
    """One constrained burst on a 48-node, 6-zone cluster: init pods,
    then 40-60 pods of the family's spec (after the perf matrix's rows,
    benchmarks/config/performance-config.yaml:86-145, scaled down)."""

    def pod(mk_pod, name, ts, labels):
        return (
            mk_pod(name).creation_timestamp(ts).labels(**labels)
            .container(cpu="100m", memory="128Mi")
        )

    def measured(mk_pod, i):
        if family == "spread":
            return pod(mk_pod, f"m{i}", 1000.0 + i, {"app": "spread"}) \
                .spread_constraint(
                    max_skew=1, topology_key=ZONE,
                    when_unsatisfiable="DoNotSchedule",
                    match_labels={"app": "spread"},
                )
        if family == "anti":
            return pod(mk_pod, f"m{i}", 1000.0 + i, {"color": "red"}) \
                .pod_affinity(HOST, {"color": "red"}, anti=True)
        if family == "affinity":
            return pod(mk_pod, f"m{i}", 1000.0 + i, {"peer": "base"}) \
                .pod_affinity(ZONE, {"peer": "base"})
        if family == "preferred":
            return pod(mk_pod, f"m{i}", 1000.0 + i, {"pref": "base"}) \
                .preferred_pod_affinity(ZONE, {"pref": "base"}, weight=10)
        return pod(mk_pod, f"m{i}", 1000.0 + i, {"svc": "web"})

    init_labels = {
        "spread": {"app": "spread"}, "anti": {"color": "blue"},
        "affinity": {"peer": "base"}, "preferred": {"pref": "base"},
        "service": {"svc": "web"},
    }[family]
    # anti-affinity pods each need a node of their own
    n_init, n_measured = 8, 40 if family == "anti" else 60

    def second_wave(client, mk_pod):
        if family == "preferred":
            # existing pods whose preferred terms score every later batch
            client.create_pods_bulk([
                pod(mk_pod, f"e{i}", 500.0 + i, {"pref": "base"})
                .preferred_pod_affinity(ZONE, {"pref": "base"}, weight=5)
                .obj()
                for i in range(4)
            ])
            _wait_bound(client, n_init + 4)
        done = n_init + (4 if family == "preferred" else 0)
        pods = [measured(mk_pod, i).obj() for i in range(n_measured)]
        for lo in range(0, n_measured, 20):
            client.create_pods_bulk(pods[lo:lo + 20])
        _wait_bound(client, done + n_measured)

    services = [("web", {"svc": "web"})] if family == "service" else []
    return dict(
        nodes=48, zones=6, max_batch=32, extra=second_wave,
        labels=init_labels, services=services,
        caps=("8", "16Gi"),
    ), _pod_specs(n_init, seed=9)


@pytest.mark.parametrize(
    "family", ["spread", "anti", "affinity", "preferred", "service"]
)
def test_constrained_burst_places_like_the_jax_package(family):
    run, specs = _family_burst(family)
    want, _ = _run("jax", specs, **run)
    got, sched = _run("torch", specs, device="cpu", **run)
    assert all(got.values()), [k for k, v in got.items() if not v][:5]
    assert got == want
    assert sched.pods_fallback == 0
    assert sched.envelope_fallbacks == 0
    tiers = sched.ladder.solves_by_tier
    assert tiers["torch"] > 0
    assert tiers["cuda"] == tiers["host_greedy"] == tiers["sequential"] == 0
    if family == "anti":
        hosts = [v for k, v in got.items() if k.startswith("m")]
        assert len(hosts) == 40 and len(set(hosts)) == 40


def _drain_then_constrained(stack, **kw):
    """Drive the batch loop by hand with no committer thread, so a
    dispatched batch stays in flight: a plain batch is dispatched, then a
    hard-spread batch whose counts must include the in-flight placements.
    Returns (placements, scheduler)."""
    Server, Cl, Informers, new, mk_node, mk_pod = STACKS[stack]
    server = Server()
    client = Cl(server)
    informers = Informers(server)
    sched = new(client, informers, batch=True, max_batch=32, **kw)
    sched._ensure_committer = lambda: None  # in flight until drained
    for i in range(12):
        client.create_node(
            mk_node(f"n{i}").capacity(cpu="8", memory="16Gi", pods=110)
            .label(HOST, f"n{i}").label(ZONE, f"zone-{i % 3}").obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()

    def dispatch(want):
        done = 0
        for _ in range(100):
            done += sched.schedule_batch(timeout=0.2, pipeline=True)
            if done >= want:
                return
        raise AssertionError(f"only {done}/{want} pods dispatched")

    try:
        client.create_pods_bulk([
            mk_pod(f"plain{i}").creation_timestamp(float(i))
            .labels(app="web").container(cpu="500m", memory="256Mi").obj()
            for i in range(8)
        ])
        dispatch(8)
        assert sched._pending_exists()
        client.create_pods_bulk([
            mk_pod(f"spread{i}").creation_timestamp(100.0 + i)
            .labels(app="web").container(cpu="100m", memory="64Mi")
            .spread_constraint(
                max_skew=1, topology_key=ZONE,
                when_unsatisfiable="DoNotSchedule",
                match_labels={"app": "web"},
            ).obj()
            for i in range(10)
        ])
        dispatch(10)
        sched._drain_pending()
        sched.wait_for_inflight_binds()
        return {
            p.metadata.name: p.spec.node_name for p in client.list_pods()[0]
        }, sched
    finally:
        sched.stop()
        informers.stop()


def test_a_constrained_pack_lands_the_batches_in_flight_first():
    """The hard-spread batch's counts come from the host cache, so the
    plain batch still in flight must commit before the pack (the
    pipeline drain): the port drains it, as the JAX package does, and
    places every pod as the JAX package does."""
    want, jsched = _drain_then_constrained("jax")
    got, sched = _drain_then_constrained("torch", device="cpu")
    assert all(got.values())
    assert got == want
    assert sched.pipeline_drains >= 1
    assert sched.pipeline_drains == jsched.pipeline_drains
    assert sched.ladder.solves_by_tier["torch"] >= 2
    assert sched.pods_fallback == 0


def test_a_fault_on_the_card_raises_instead_of_solving_on_the_cpu(
    monkeypatch,
):
    """With the solver's tensors on the card, a failed device solve (here
    a stand-in for an illegal-address fault) propagates out of the batch
    loop: no host-greedy or sequential tier solves the batch on the CPU,
    and no pod binds."""
    import torch

    from kubernetes_tpu_torch.scheduler import batch as batch_mod

    def faulting_solve(*_args, **_kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, max_batch=32,
                          device="cpu")
    for i in range(4):
        client.create_node(
            make_node(f"n{i}").capacity(cpu="4", memory="8Gi", pods=110).obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    try:
        client.create_pods_bulk([
            make_pod(f"p{i}").container(cpu="100m", memory="64Mi").obj()
            for i in range(8)
        ])
        monkeypatch.setattr(batch_mod, "solve_packed", faulting_solve)
        sched.device = torch.device("cuda")  # as if the tensors were there
        with pytest.raises(RuntimeError, match="illegal memory access"):
            for _ in range(50):
                if sched.schedule_batch(timeout=0.2):
                    break
        tiers = sched.ladder.solves_by_tier
        assert tiers["host_greedy"] == tiers["sequential"] == 0
        assert sched.pods_fallback == 0
        assert not any(p.spec.node_name for p in client.list_pods()[0])
    finally:
        sched.stop()
        informers.stop()


def test_entry_points_default_to_the_card():
    """No device named and no card visible: the entry point raises
    instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default is valid")
    server = APIServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        new_scheduler(Client(server), InformerFactory(server), batch=True)


def _imports(path):
    with open(path, "rb") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_sources():
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 50
    bad = []
    for path in sources:
        for mod in _imports(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "kubernetes_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


@pytest.mark.parametrize(
    "kwargs",
    [{"solver_mode": "sinkhorn"}, {"mesh": object()}],
    ids=["sinkhorn", "mesh"],
)
def test_unported_solver_modes_are_rejected(kwargs):
    server = APIServer()
    with pytest.raises(ValueError, match="later slice"):
        new_scheduler(
            Client(server), InformerFactory(server), batch=True,
            device="cpu", **kwargs,
        )
