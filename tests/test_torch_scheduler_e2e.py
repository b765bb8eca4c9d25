"""The port's ``new_scheduler`` end to end, on the CPU, beside the JAX
package's.

Twins of the 6 cases of ``tests/test_scheduler_e2e.py``: pods created
through the in-process API get bound by the scheduler loop (informers
pumped by hand, ``schedule_one`` until idle, the sequential path's
tie-break ``rng`` seeded alike): spreading by LeastAllocated, a pod
retried after a node lands, priority under scarcity, a node selector,
asynchronous binding and an untolerated taint. The port's scheduler is
built with ``device="cpu"``. Each case returns every pod's node and
its PodScheduled condition from each package; the two must be equal
(tolerance: exact) and hold the reference test's checks.
"""

import importlib
import random
import time
from types import SimpleNamespace

ROOTS = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}


def _side(pkg):
    root = ROOTS[pkg]

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        pkg=pkg,
        APIServer=m("apiserver").APIServer,
        Client=m("client").Client,
        InformerFactory=m("client").InformerFactory,
        new_scheduler=m("scheduler").new_scheduler,
        make_node=m("testing").make_node,
        make_pod=m("testing").make_pod,
        kw={"device": "cpu"} if pkg == "torch" else {},
    )


SIDES = [_side("torch"), _side("jax")]


class Stack:
    def __init__(self, s, async_binding=False):
        self.s = s
        self.api = s.APIServer()
        self.client = s.Client(self.api)
        self.factory = s.InformerFactory(self.api)
        self.sched = s.new_scheduler(self.client, self.factory,
                                     async_binding=async_binding,
                                     rng=random.Random(7), **s.kw)
        self.factory.pump()

    def node(self, name, cpu="4", memory="8Gi", **kw):
        w = self.s.make_node(name)
        if "label" in kw:
            w = w.label(*kw["label"])
        if "taint" in kw:
            w = w.taint(*kw["taint"])
        self.client.create_node(w.capacity(cpu=cpu, memory=memory).obj())

    def pod(self, name, cpu="1", memory="1Gi", priority=None,
            selector=None):
        w = self.s.make_pod(name)
        if priority is not None:
            w = w.priority(priority)
        if selector:
            w = w.node_selector(**selector)
        self.client.create_pod(w.container(cpu=cpu, memory=memory).obj())

    def drive(self, max_iters=200):
        """Pump informers and run scheduling iterations until idle."""
        for _ in range(max_iters):
            self.factory.pump()
            if not self.sched.schedule_one(timeout=0.01):
                if self.factory.pump() == 0:
                    break
        self.factory.pump()

    def outcome(self):
        out = {}
        for p in self.client.list_pods()[0]:
            cond = {c.type: (c.status, c.reason)
                    for c in p.status.conditions}.get("PodScheduled")
            out[p.metadata.name] = (p.spec.node_name, cond)
        return out


def both(case, **kw):
    out = []
    for s in SIDES:
        st = Stack(s, **kw)
        try:
            out.append(case(st))
        finally:
            st.sched.stop()
    assert out[0] == out[1]
    return out[0]


def test_pods_get_bound():
    def case(st):
        for i in range(3):
            st.node(f"n{i}")
        for i in range(6):
            st.pod(f"p{i}")
        st.drive()
        return st.outcome()

    out = both(case)
    assert all(node for node, _ in out.values()), out
    # spread over the nodes by LeastAllocated: no node got everything
    assert len({node for node, _ in out.values()}) == 3


def test_unschedulable_pod_retries_after_node_add():
    def case(st):
        st.pod("big", cpu="8")
        st.drive()
        before = st.outcome()["big"]
        # capacity arrives: the pod is woken and scheduled after backoff
        st.node("huge", cpu="16", memory="32Gi")
        st.factory.pump()
        st.sched.queue.flush_backoff_q_completed()
        deadline = time.time() + 5
        while time.time() < deadline:
            st.factory.pump()
            st.sched.queue.flush_backoff_q_completed()
            if st.sched.schedule_one(timeout=0.05):
                st.factory.pump()
                if st.client.get_pod("default", "big").spec.node_name:
                    break
        return before, st.client.get_pod("default", "big").spec.node_name

    before, after = both(case)
    assert before == ("", ("False", "Unschedulable"))
    assert after == "huge"


def test_higher_priority_scheduled_first_under_scarcity():
    def case(st):
        st.node("n", cpu="2", memory="4Gi")
        st.pod("low", cpu="2", priority=1)
        st.pod("high", cpu="2", priority=10)
        st.drive()
        return {k: v[0] for k, v in st.outcome().items()}

    assert both(case) == {"high": "n", "low": ""}


def test_node_selector_respected_e2e():
    def case(st):
        st.node("gpu-node", label=("accel", "tpu"))
        st.node("plain")
        st.pod("picky", selector={"accel": "tpu"})
        st.drive()
        return st.outcome()["picky"][0]

    assert both(case) == "gpu-node"


def test_async_binding_mode():
    def case(st):
        st.node("n", cpu="8", memory="16Gi")
        for i in range(4):
            st.pod(f"p{i}")
        for _ in range(10):
            st.factory.pump()
            st.sched.schedule_one(timeout=0.05)
        assert st.sched.wait_for_inflight_binds(timeout=5)
        st.factory.pump()
        return {k: v[0] for k, v in st.outcome().items()}

    assert both(case, async_binding=True) == {f"p{i}": "n" for i in range(4)}


def test_tainted_node_avoided():
    def case(st):
        st.node("tainted", taint=("dedicated", "infra"))
        st.node("open")
        st.pod("p")
        st.drive()
        return st.outcome()["p"][0]

    assert both(case) == "open"
