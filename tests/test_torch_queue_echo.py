"""The status-write echo that drains an in-flight pod twice, pinned in
both packages on the CPU.

A pod requeued with a status write (the PodScheduled=False condition
the failure path writes) can be popped again before the informer
delivers that write back. The echo then finds the pod in no queue, and
the queue's ``update`` re-adds it (its last branch), so the pod is
drained a second time while its first copy is in flight -- into the next
batch, or into the same batch when the echo lands during a drain's
window wait. The fix belongs in both packages' queue, and the JAX
package is the reference, so the port keeps the same behaviour: these
tests document it and hold the port to the JAX package's drains, with
the informers pumped by hand so the echo lands exactly where each case
puts it.
"""

import threading
from collections import Counter

import pytest

from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_pod

PKG = {
    "jax": (JaxAPIServer, JaxClient, JaxInformers, jax_new, jax_pod, {}),
    "torch": (APIServer, Client, InformerFactory, new_scheduler, make_pod,
              {"device": "cpu"}),
}


def _condition_types(pkg):
    if pkg == "jax":
        from kubernetes_tpu.api.types import PodCondition
    else:
        from kubernetes_tpu_torch.api.types import PodCondition
    return PodCondition


def _echo_drains(pkg, one_batch):
    """Four pods; e0 is popped, requeued to the activeQ with a status
    write, and drained again before its echo lands; then the echo is
    pumped and the queue drained once more (``one_batch``: the echo lands
    while that same drain waits out its window). Returns the names of
    every drained pod, in drain order, one list per batch."""
    Server, Cl, Informers, new, mk_pod, kw = PKG[pkg]
    PodCondition = _condition_types(pkg)
    server = Server()
    client = Cl(server)
    informers = Informers(server)  # pumped by hand, never started
    sched = new(client, informers, batch=True, max_batch=8, **kw)
    q = sched.queue
    for i in range(4):
        client.create_pod(
            mk_pod(f"e{i}").creation_timestamp(float(i))
            .container(cpu="100m", memory="128Mi").obj()
        )
    informers.pump()
    first = q.pop(timeout=1.0)
    assert first.pod.metadata.name == "e0"
    q.add_unschedulable_if_not_present(
        first, q.scheduling_cycle, skip_backoff=True
    )

    def unschedulable(p):
        p.status.conditions = [
            PodCondition(type="PodScheduled", status="False",
                         reason="Unschedulable", message="0/0 nodes")
        ]

    client.update_pod_status("default", "e0", unschedulable)
    batches = []
    if not one_batch:
        batches.append(q.pop_batch(8, timeout=1.0))
        informers.pump()  # the echo: e0 is in flight, in no queue
        batches.append(q.pop_batch(8, timeout=1.0))
    else:
        out = []
        drain = threading.Thread(
            target=lambda: out.append(q.pop_batch(5, timeout=1.0,
                                                  window=30.0)),
            daemon=True,
        )
        drain.start()
        tick = threading.Event()
        for _ in range(200):  # the drain took e0..e3 and waits
            if len(q.active_q) == 0:
                break
            tick.wait(0.01)
        informers.pump()  # the echo lands during the window
        drain.join(timeout=10.0)
        assert not drain.is_alive()
        batches.append(out[0])
    q.close()
    return [[pi.pod.metadata.name for pi in b] for b in batches]


@pytest.mark.parametrize("one_batch", [False, True],
                         ids=["next_batch", "same_batch"])
def test_an_echoed_status_write_drains_an_in_flight_pod_twice(one_batch):
    drains = {pkg: _echo_drains(pkg, one_batch) for pkg in PKG}
    assert drains["torch"] == drains["jax"]
    # the reference's behaviour, kept by the port: e0 is drained twice
    every = Counter(n for b in drains["torch"] for n in b)
    assert every == Counter({"e0": 2, "e1": 1, "e2": 1, "e3": 1})
    if one_batch:
        assert len(drains["torch"]) == 1
        assert Counter(drains["torch"][0])["e0"] == 2
    else:
        assert drains["torch"][1] == ["e0"]
