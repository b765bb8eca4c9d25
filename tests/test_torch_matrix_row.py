"""``chip_smoke.py``'s ``matrix_row`` on the CPU: the stop of a row.

A row whose bound fraction is below 1 (GangContention/500) stops the
scheduling loop once the binds go quiet, then holds the host cache
against the apiserver's bound pods. The stopping loop lands the batches
still in flight and hands their binds to the bind pool, so the row must
wait for those binds before it compares. This test forces such a batch:
once 320 pods are assumed, every commit waits until ``stop()`` has
returned, the quiet wait returns as soon as one commit waits there, and
every bind sent after the stop is slowed. GangContention/500's node and
pod shapes (4 pods of 1000m/2Gi a node) without its PodGroups (a gang
split by the stop would wait at Permit instead), cut to 100 nodes and
800 pods at max_batch 64. Tolerance: exact (the cache equal to the
bound pods; 360 of the cluster's 400 slots bound, the row's fraction).
"""

import os
import sys
import threading
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from kubernetes_tpu_torch.client.client import Client  # noqa: E402
from kubernetes_tpu_torch.ops import greedy_kernel  # noqa: E402
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler  # noqa: E402
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler  # noqa: E402

ROW = dict(
    [r for r in chip_smoke.GANG_ROWS if r["name"] == "GangContention/500"][0],
    nodes=100, measured=800, max_batch=64, gang=None,
)
GATE_AT = 320


@pytest.mark.parametrize("bind_delay_s", [0.0, 0.5])
def test_row_waits_for_the_binds_the_stopping_loop_hands_off(
    monkeypatch, bind_delay_s
):
    held, stopped = threading.Event(), threading.Event()
    complete, stop = BatchScheduler._complete_solve, Scheduler.stop

    def gated_complete(self, p):
        if sum(len(ni.pods) for ni in self.cache._nodes.values()) >= GATE_AT:
            held.set()
            assert stopped.wait(60), "the row never stopped its loop"
        return complete(self, p)

    def stop_then_open(self):
        stop(self)
        stopped.set()

    def quiet_once_held(watch, need, timeout, settle=2.0):
        return held.wait(timeout)

    def slowed(bind):
        def slow_bind(self, *args, **kwargs):
            if stopped.is_set():
                time.sleep(bind_delay_s)
            return bind(self, *args, **kwargs)
        return slow_bind

    monkeypatch.setattr(chip_smoke, "wait_quiet", quiet_once_held)
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **k: None)
    monkeypatch.setattr(BatchScheduler, "_complete_solve", gated_complete)
    monkeypatch.setattr(Scheduler, "stop", stop_then_open)
    monkeypatch.setattr(Client, "bind", slowed(Client.bind))
    monkeypatch.setattr(Client, "bind_assumed_bulk",
                        slowed(Client.bind_assumed_bulk))
    rec = chip_smoke.matrix_row(ROW, greedy_kernel, device="cpu")
    assert held.is_set() and stopped.is_set()
    assert rec["bound"] >= int(ROW["min_bound_fraction"] * ROW["measured"])
    assert rec["bound"] <= ROW["nodes"] * 4


def test_a_gang_row_chains_only_the_solves_that_stood(monkeypatch):
    """A row checked against the host greedy chained over its solves,
    whose gangs re-solve: GangContention/500's shapes with groups of 20
    (room for half of them), cut to 100 nodes and 800 pods at max_batch
    64. A re-solve's first attempt was rewound off the carry and is not
    chained, a solve handed an uploaded state starts the chain again, and
    a member masked at the commit is not placed; chaining every solve
    (the harness before) failed on the rewound attempts."""
    row = dict(ROW, gang=dict(group_size=20, min_member=20), chain=True)
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **k: None)
    rec = chip_smoke.matrix_row(row, greedy_kernel, device="cpu")
    assert rec["gang_resolves"] >= 1
    assert rec["bound"] % 20 == 0 and rec["groups_whole"] * 20 == rec["bound"]
