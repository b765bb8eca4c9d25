"""The card's answer to each solver fault, on the CPU.

The batch scheduler's device is named ``cuda`` and its solves run the
kernels' plain versions on the CPU (``solve_packed`` is pointed at the
CPU): every decision that reads the device's type or the tier's name
takes the card's branch, and no tensor leaves the CPU. The answers
(``robustness/ladder.py``; the JAX package steps each of these down to
``host_greedy`` instead):

- injected ``solve_garbage``: the download is read again in place under
  the RetryPolicy; spent attempts requeue the batch on the backoff clock
  for K1, with no halt; an invalid download no injector produced halts;
- injected ``device_solve_hang`` longer than ``solveTimeout``: retried in
  place, then requeued for K1; the scheduler does not halt;
- ``device-down`` (every solve fails): nothing binds while it lasts, no
  pod is quarantined for it, nothing halts, and every pod binds once it
  is lifted;
- a solve that raises (a kernel that cannot launch): the scheduler halts
  with a ``CardFault`` caused by it;
- resident state dropped on another thread between the handshake and the
  solve (the committer's recovery of a failed batch drops the carry): the
  dispatch is redone from the host state and places as it would have,
  where it used to hand K1 a missing carry and halt.
"""

import time

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.ops.greedy_kernel import KernelError
from kubernetes_tpu_torch.robustness.circuit import RetryPolicy
from kubernetes_tpu_torch.robustness.faults import (
    FaultInjector,
    FaultPoint,
    FaultProfile,
    PointConfig,
    install_injector,
)
from kubernetes_tpu_torch.robustness.ladder import CardFault, RobustnessConfig
from kubernetes_tpu_torch.scheduler import batch as batch_mod
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod


@pytest.fixture(autouse=True)
def _clean_injector():
    yield
    install_injector(None)


@pytest.fixture
def card(monkeypatch):
    """A batch scheduler whose device is named ``cuda``, solving on the
    CPU: (sched, client, informers)."""
    orig = batch_mod.solve_packed

    def on_cpu(*a, **kw):
        kw["device"] = torch.device("cpu")
        return orig(*a, **kw)

    monkeypatch.setattr(batch_mod, "solve_packed", on_cpu)
    made = []

    def make(nodes=8, robustness=None, **kw):
        server = APIServer()
        client = Client(server)
        informers = InformerFactory(server)
        sched = new_scheduler(
            client, informers, batch=True, max_batch=16, device="cpu",
            robustness_config=robustness or RobustnessConfig(
                retry=RetryPolicy(max_attempts=2, backoff_seconds=0.0)),
            **kw)
        sched.device = torch.device("cuda")
        sched.batch_window = 0.0
        sched.queue._initial_backoff = sched.queue._max_backoff = 0.0
        for i in range(nodes):
            client.create_node(make_node(f"n{i}").capacity(
                cpu="8", memory="16Gi", pods=110).obj())
        informers.pump()
        made.append((sched, informers))
        return sched, client, informers

    yield make
    for sched, informers in made:
        sched.stop()
        informers.stop()


def _wave(client, informers, prefix, n):
    client.create_pods_bulk([make_pod(f"{prefix}{i}").container(
        cpu="250m", memory="256Mi").obj() for i in range(n)])
    informers.pump()


def _step(sched, informers):
    n = sched.schedule_batch(timeout=0.05, pipeline=False)
    sched.wait_for_inflight_binds()
    informers.pump()
    return n


def _bound(client):
    return sum(1 for p in client.list_pods()[0] if p.spec.node_name)


@pytest.mark.parametrize("fires", [1, 2], ids=["retried", "exhausted"])
def test_injected_garbage_is_read_again_then_requeued(card, fires):
    """One garbage download is read again and the batch commits; two spend
    the two attempts and the batch is requeued for K1 (backoff, not the
    unschedulable queue), with the carry dropped and no halt."""
    sched, client, informers = card()
    inj = FaultInjector(FaultProfile("g", seed=0, points={
        FaultPoint.SOLVE_GARBAGE: PointConfig(rate=1.0, max_fires=fires)}))
    install_injector(inj)
    _wave(client, informers, "p", 12)
    assert _step(sched, informers) == 12
    assert inj.fired_count(FaultPoint.SOLVE_GARBAGE) == fires
    assert sched.card_fault is None
    assert sched.injected_retries == 1
    if fires == 1:
        assert _bound(client) == 12 and sched.injected_exhaustions == 0
        return
    assert _bound(client) == 0 and sched.injected_exhaustions == 1
    assert sched._dev.req_dev is None
    pending = sched.queue.num_pending()
    assert pending["unschedulable"] == 0
    assert pending["active"] + pending["backoff"] == 12
    sched.queue.flush_backoff_q_completed()
    assert _step(sched, informers) == 12
    assert _bound(client) == 12
    assert set(k for k, v in sched.ladder.solves_by_tier.items() if v) == {
        "cuda"}


def test_garbage_no_injector_made_halts(card, monkeypatch):
    """An out-of-range download with no injected fault behind it is the
    card's: the completion fails and the scheduler halts on it."""
    sched, client, informers = card()
    real = batch_mod._to_host
    monkeypatch.setattr(batch_mod.BatchScheduler, "_eager_download",
                        staticmethod(lambda dev: None))
    monkeypatch.setattr(batch_mod, "_to_host",
                        lambda a: np.full_like(real(a), 1 << 30))
    _wave(client, informers, "p", 4)
    with pytest.raises(RuntimeError, match="out-of-range"):
        _step(sched, informers)
    assert isinstance(sched.card_fault, RuntimeError)
    assert sched._stop.is_set()


def test_injected_hang_past_the_watchdog_is_retried_then_requeued(card):
    """``robustness.solveTimeout`` shorter than an injected hang: a hang is
    retried in place; two spend the attempts, the batch exhausts and is
    bisected into K1 sub-solves, whose one hang is retried again. No
    halt, no pod quarantined, every pod bound on the ``cuda`` tier, and
    no hung attempt launches a late solve."""
    sched, client, informers = card(robustness=RobustnessConfig(
        solve_timeout_seconds=1.0,
        retry=RetryPolicy(max_attempts=2, backoff_seconds=0.0)))
    solves = []
    orig = batch_mod.solve_packed

    def counting(*a, **kw):
        solves.append(1)
        return orig(*a, **kw)

    batch_mod.solve_packed = counting
    try:
        inj = FaultInjector(FaultProfile("h", seed=0, points={
            FaultPoint.DEVICE_SOLVE_HANG: PointConfig(
                rate=1.0, max_fires=3, hang_seconds=1.2)}))
        install_injector(inj)
        _wave(client, informers, "p", 6)
        _step(sched, informers)
        time.sleep(1.3)  # every hung attempt has woken by now
        assert sched.card_fault is None
        assert inj.fired_count(FaultPoint.DEVICE_SOLVE_HANG) == 3
        assert (sched.injected_retries, sched.injected_exhaustions) == (2, 1)
        assert sched.bisections == 1 and len(solves) == 2
        assert _bound(client) == 6
        assert sched.queue.quarantine_parked_count() == 0
        assert {k for k, v in sched.ladder.solves_by_tier.items() if v} == {
            "cuda"}
    finally:
        batch_mod.solve_packed = orig


@pytest.mark.parametrize("pods", [1, 40])
def test_device_down_binds_nothing_then_everything(card, pods):
    """``device-down`` on a lone pod (the same singleton exhausting again
    and again, which the crash-loop detector would quarantine) and on a
    40-pod backlog (bisected batches): nothing binds and nothing halts
    while it lasts, no pod is quarantined, and once it is lifted every
    pod binds on the ``cuda`` tier."""
    sched, client, informers = card(nodes=16)
    install_injector(FaultInjector(FaultProfile("device-down", seed=0,
        points={FaultPoint.DEVICE_SOLVE: PointConfig(rate=1.0)})))
    _wave(client, informers, "p", pods)
    for _ in range(6):
        _step(sched, informers)
        sched.queue.flush_backoff_q_completed()
    assert _bound(client) == 0
    assert sched.card_fault is None
    assert sched.injected_exhaustions >= 6
    assert sched.queue.quarantine_parked_count() == 0
    assert sched.queue.quarantine_held_count() == 0
    install_injector(None)
    for _ in range(10):
        if _bound(client) == pods:
            break
        sched.queue.move_all_to_active_or_backoff_queue("retry")
        sched.queue.flush_backoff_q_completed()
        _step(sched, informers)
    assert _bound(client) == pods
    tiers = {k for k, v in sched.ladder.solves_by_tier.items() if v}
    assert tiers == {"cuda"} and sched.pods_fallback == 0


def test_a_solve_that_raises_halts_with_a_card_fault(card, monkeypatch):
    """A K1 launch that raises (here the kernel refusing its shape) is not
    retried, not requeued and not stepped down: the loop halts with a
    CardFault caused by it, and the pod stays pending."""
    sched, client, informers = card()

    def refuses(*a, **kw):
        raise KernelError("19000 bytes of shared memory per CTA exceed "
                          "232448")

    monkeypatch.setattr(batch_mod, "solve_packed", refuses)
    informers.start()
    _wave(client, informers, "p", 3)
    loop = sched.start()
    deadline = time.time() + 10
    while sched.card_fault is None and time.time() < deadline:
        time.sleep(0.02)
    loop.join(timeout=10)
    assert not loop.is_alive()
    assert isinstance(sched.card_fault, CardFault)
    assert isinstance(sched.card_fault.__cause__, KernelError)
    assert sched._stop.is_set()
    assert _bound(client) == 0
    assert sched.injected_retries == 0


def _placements(client):
    return {p.metadata.name: p.spec.node_name for p in client.list_pods()[0]}


@pytest.mark.parametrize("dropped", ["carry", "alloc"])
def test_state_dropped_mid_dispatch_is_redispatched(card, dropped):
    """The second batch's handshake negotiates the resident carry; before
    the dispatch reads it, the carry (as the committer's recovery drops
    it) or the resident allocatable (as a carry audit's heal drops it) is
    gone. The dispatch undoes its booking, uploads the host state and
    places every pod exactly as an undisturbed scheduler does, on K1's
    tier alone, with no halt."""
    runs = {}
    for disturb in (False, True):
        sched, client, informers = card()
        _wave(client, informers, "a", 12)
        assert _step(sched, informers) == 12
        orig = sched._negotiate_device_state
        calls = []

        def negotiate(*a, **kw):
            neg = orig(*a, **kw)
            calls.append(neg)
            if disturb and len(calls) == 1:
                with sched._shadow_lock:
                    if dropped == "carry":
                        sched._dev.invalidate_carry()
                    else:
                        sched._dev.alloc_dev = sched._dev.valid_dev = None
            return neg

        sched._negotiate_device_state = negotiate
        _wave(client, informers, "b", 12)
        assert _step(sched, informers) == 12
        assert sched.card_fault is None
        assert _bound(client) == 24
        assert calls[0]["carry_ok"] and calls[0]["static_ok"]
        tiers = {k: v for k, v in sched.ladder.solves_by_tier.items() if v}
        assert tiers == {"cuda": 2}
        assert sched.carry_drop_redispatches == int(disturb)
        assert (sched.state_uploads, sched.state_reuses) == (
            (2, 0) if disturb else (1, 1))
        runs[disturb] = _placements(client)
    assert runs[True] == runs[False]
