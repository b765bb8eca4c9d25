"""The admission classifier, on the CPU, in both packages.

Twins of the 13 cases of ``tests/test_admission.py``: the port's
``scheduler/admission.py`` through its batch scheduler
(``device="cpu"``) -- the device/host verdicts and their reasons, the
volume counts, the memo read on the dispatch path, re-classification
after a PVC binding lands mid-queue, after a queued pod's volumes
change and under a foreign owner's token, classification on ingest, and
the CSINode limits reaching the cache -- against the JAX package's
scheduler on the same objects, pumped by hand so each step is
deterministic. Every case returns what the reference checks from each
package; the two must be equal (tolerance: exact) and hold the
reference's assertions.
"""

import importlib
from types import SimpleNamespace

ROOTS = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}
EBS = "attachable-volumes-csi-ebs.csi.aws.com"


def _side(pkg):
    root = ROOTS[pkg]

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        pkg=pkg,
        types=m("api.types"),
        APIServer=m("apiserver.server").APIServer,
        Client=m("client.client").Client,
        InformerFactory=m("client.informer").InformerFactory,
        new_scheduler=m("scheduler.scheduler").new_scheduler,
        VOLUME_UNLIMITED=m("cache.node_info").VOLUME_UNLIMITED,
        make_node=m("testing").make_node,
        make_pod=m("testing").make_pod,
        kw={"device": "cpu"} if pkg == "torch" else {},
    )


SIDES = [_side("torch"), _side("jax")]


class Stack:
    """Pump-mode stack: informer events drain on the test thread."""

    def __init__(self, s):
        self.s = s
        self.server = s.APIServer()
        self.client = s.Client(self.server)
        self.informers = s.InformerFactory(self.server)
        self.sched = s.new_scheduler(self.client, self.informers,
                                     batch=True, max_batch=16, **s.kw)

    def bound_csi_pv(self, claim, volume, driver="ebs.csi.aws.com"):
        T = self.s.types
        self.server.create(T.PersistentVolumeClaim(
            metadata=T.ObjectMeta(name=claim, namespace="default"),
            volume_name=volume, requested_bytes=1 << 30))
        self.server.create(T.PersistentVolume(
            metadata=T.ObjectMeta(name=volume, namespace=""),
            capacity_bytes=1 << 30, claim_ref_namespace="default",
            claim_ref_name=claim, csi_driver=driver,
            csi_volume_handle=volume))

    def node(self, name, cpu="8", memory="16Gi"):
        self.client.create_node(
            self.s.make_node(name).capacity(cpu=cpu, memory=memory).obj())
        self.informers.pump()

    def csi_node(self, name, driver, count):
        T = self.s.types
        self.server.create(T.CSINode(
            metadata=T.ObjectMeta(name=name, namespace=""),
            drivers=[T.CSINodeDriver(name=driver, node_id=name,
                                     allocatable_count=count)]))
        self.informers.pump()


def both(case):
    out = []
    for s in SIDES:
        st = Stack(s)
        try:
            out.append(case(st))
        finally:
            st.sched.stop()
            st.informers.stop()
    assert out[0] == out[1]
    return out[0]


def _verdict(adm):
    return adm.device_ok, adm.reason, adm.klass


# -- TestClassification -------------------------------------------------------


def test_plain_pod_is_device_class():
    assert both(lambda st: _verdict(st.sched.classify_pod(
        st.s.make_pod("p").container(cpu="1").obj()))) == (
        True, "", "device")


def test_numa_annotation_is_host():
    def case(st):
        pod = st.s.make_pod("p").container(cpu="1").obj()
        pod.metadata.annotations["numa.kubernetes-tpu.io/aligned"] = "2"
        return _verdict(st.sched.classify_pod(pod))

    assert both(case) == (False, "numa-aligned", "host")


def test_direct_volume_source_is_host_but_counted():
    def case(st):
        adm = st.sched.classify_pod(
            st.s.make_pod("p").container(cpu="1").gce_pd("disk-1").obj())
        return adm.device_ok, adm.reason, adm.vol_counts

    assert both(case) == (False, "direct-volume-source",
                          (("attachable-volumes-gce-pd", 1),))


def test_constrained_shapes_keep_device_class():
    def case(st):
        adm = st.sched.classify_pod(
            st.s.make_pod("p").container(cpu="1")
            .pod_affinity("zone", {"a": "b"}, anti=True).obj())
        return (adm.device_ok, bool(adm.required_anti),
                bool(adm.affinity_req), adm.klass)

    assert both(case) == (True, True, True, "constrained")


def test_bound_csi_pvc_is_device_with_counts():
    def case(st):
        st.bound_csi_pv("c1", "v1")
        st.informers.pump()
        pod = st.s.make_pod("p").container(cpu="1").pvc("c1").obj()
        adm = st.sched._admission_of(pod)
        return (adm.device_ok, adm.reason, adm.vol_counts, adm.has_pvc,
                pod.__dict__["_volcount_memo"] == adm.vol_counts,
                # the pop-time read registered the volume column
                EBS in st.sched.tensor_cache.dims.volume_columns())

    assert both(case) == (True, "", ((EBS, 1),), True, True, True)


def test_unbound_pvc_is_host():
    assert both(lambda st: _verdict(st.sched.classify_pod(
        st.s.make_pod("p").container(cpu="1").pvc("nope").obj())))[:2] == (
        False, "unbound-pvc")


def test_memo_reused_on_hot_path():
    def case(st):
        pod = st.s.make_pod("p").container(cpu="1").obj()
        a1 = st.sched._admission_of(pod)
        n = st.sched.admissions_classified
        a2 = st.sched._admission_of(pod)
        return a1 is a2, st.sched.admissions_classified - n

    assert both(case) == (True, 0)


# -- TestStaleClassification --------------------------------------------------


def test_pvc_binding_mid_queue_reclassifies():
    """A pod classified host-only (unbound claim) whose PVC binding lands
    while it waits is re-classified at pop time."""
    def case(st):
        st.node("n0")
        st.client.create_pod(
            st.s.make_pod("p").container(cpu="1").pvc("c1").obj())
        st.informers.pump()
        queued = st.sched.queue.pending_pods()
        first = queued[0].__dict__["_admission"]
        gen_before = st.sched._volume_topo_gen
        st.bound_csi_pv("c1", "v1")
        st.informers.pump()
        gen_bumped = st.sched._volume_topo_gen > gen_before
        reclass = st.sched.reclassifications
        adm = st.sched._admission_of(queued[0])
        return (len(queued), _verdict(first)[:2], gen_bumped,
                st.sched.reclassifications - reclass, adm.device_ok,
                adm.vol_counts)

    assert both(case) == (1, (False, "unbound-pvc"), True, 1, True,
                          ((EBS, 1),))


def test_mutated_volumes_reclassify():
    """An update of a queued pod's volumes replaces it in the queue; the
    new object is classified on ingest and routed by its new class."""
    def case(st):
        st.node("n0")
        st.client.create_pod(st.s.make_pod("p").container(cpu="1").obj())
        st.informers.pump()
        queued = st.sched.queue.pending_pods()[0]
        was_device = queued.__dict__["_admission"].device_ok
        updated = queued.deepcopy()
        updated.spec.volumes = (
            st.s.make_pod("tmp").gce_pd("disk-1").obj().spec.volumes)
        st.client.update_pod(updated)
        st.informers.pump()
        queued2 = st.sched.queue.pending_pods()[0]
        adm = queued2.__dict__["_admission"]
        st.sched.queue.run()
        n_fallback = st.sched.pods_fallback
        st.sched.schedule_batch(timeout=0.1)
        st.sched.wait_for_inflight_binds()
        return (was_device, queued2 is not queued, adm.device_ok,
                adm.reason, st.sched.pods_fallback - n_fallback)

    assert both(case) == (True, True, False, "direct-volume-source", 1)


def test_foreign_token_reclassifies():
    def case(st):
        pod = st.s.make_pod("p").container(cpu="1").obj()
        adm = st.sched.classify_pod(pod)
        adm.token = object()  # another scheduler's memo
        n = st.sched.admissions_classified
        adm2 = st.sched._admission_of(pod)
        return adm2 is not adm, st.sched.admissions_classified - n

    assert both(case) == (True, 1)


# -- TestIngestClassification -------------------------------------------------


def test_burst_classified_on_ingest_not_dispatch():
    def case(st):
        st.node("n0", cpu="32", memory="64Gi")
        for i in range(10):
            st.client.create_pod(
                st.s.make_pod(f"p{i}").container(cpu="100m").obj())
        st.informers.pump()
        n = st.sched.admissions_classified
        batch = st.sched.queue.pop_batch(16)
        verdicts = [st.sched._admission_of(pi.pod).device_ok for pi in batch]
        return n >= 10, verdicts, st.sched.admissions_classified - n

    assert both(case) == (True, [True] * 10, 0)


# -- TestCSINodeCache ---------------------------------------------------------


def test_csi_node_limits_reach_node_info():
    def case(st):
        st.node("n0")
        st.csi_node("n0", "ebs.csi.aws.com", 3)
        ni = st.sched.cache._nodes["n0"]
        return (ni.csi_volume_limits, ni.volume_limit(EBS),
                ni.volume_limit("attachable-volumes-csi-other")
                == st.s.VOLUME_UNLIMITED,
                ni.volume_limit("attachable-volumes-aws-ebs"))

    # an unknown driver is unlimited; in-tree takes the reference default
    assert both(case) == ({EBS: 3}, 3, True, 39)


def test_csi_node_before_node_applies_on_add():
    def case(st):
        st.csi_node("late", "d", 5)
        st.node("late")
        return st.sched.cache._nodes["late"].csi_volume_limits

    assert both(case) == {"attachable-volumes-csi-d": 5}
