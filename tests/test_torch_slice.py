"""The port's main path as a whole, on the CPU, against the JAX package.

The same seeded cluster and plain-pod burst go through the JAX
package's batch scheduler and through the port's
(``new_scheduler(batch=True, device="cpu")``): every pod binds, and
the placements are equal pod for pod. A required-anti-affinity batch --
a constrained solve the port does not have yet -- takes the port's
sequential route and still binds correctly. And no module of the port
imports JAX or the JAX package.
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


def _run(stack, specs, nodes=64, max_batch=128, extra=None, caps=None,
         **kw):
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
        client.create_node(
            mk_node(f"n{i}")
            .capacity(cpu=cpu, memory=mem, pods=110)
            .label("kubernetes.io/hostname", f"n{i}")
            .obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.start()
    try:
        pods = [
            mk_pod(name).creation_timestamp(float(i))
            .container(cpu=cpu, memory=mem).obj()
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
    assert sched.constrained_not_ported == 0
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
    """Pods with required anti-affinity need the constrained solve: the
    port routes their batch to the sequential path, and they still land
    on distinct nodes."""
    n_anti = 4

    def anti_batch(client, mk_pod):
        client.create_pods_bulk([
            mk_pod(f"anti{i}").labels(app="db")
            .container(cpu="100m", memory="64Mi")
            .pod_affinity(
                "kubernetes.io/hostname", {"app": "db"}, anti=True
            ).obj()
            for i in range(n_anti)
        ])
        _wait_bound(client, 40 + n_anti)

    placements, sched = _run(
        "torch", _pod_specs(40, seed=6), nodes=8, extra=anti_batch,
        device="cpu",
    )
    assert all(placements.values())
    hosts = [placements[f"anti{i}"] for i in range(n_anti)]
    assert len(set(hosts)) == n_anti
    assert sched.constrained_not_ported >= 1
    assert sched.pods_fallback >= n_anti
    assert sched.ladder.solves_by_tier["cuda"] == 0


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
