"""The HTTP extender (``scheduler/extender.py``) in both packages, against
one real in-process HTTP server, on the CPU.

Twins of the seven tests of ``tests/test_extender.py``, each run through
the JAX package and the port with the same handler and held to the
reference test's checks, their outcomes equal: filter and prioritize
with and without the node cache, managed-resource interest, ignorable
and non-ignorable errors, the end-to-end bind, and the pod's wire form
(the same Pod gives the same JSON from both packages, as the extender's
``ExtenderArgs`` and as ``api/serialization.pod_to_dict``). Then:

- the batch path with a binder extender: 40 nodes, 60 pods, one in five
  requesting the managed resource, through ``new_scheduler(batch=True,
  extenders=[...])`` in both packages, popped as one batch and driven by
  hand. The interested pods leave the batch for the sequential path
  (the extender filters, prioritizes and binds them through the client),
  the others are solved by K1's plain version in the port and by the JAX
  package's own solve; both packages bind the same pods to the same
  nodes. The sequential path breaks score ties at random, so both are
  handed ``random.Random`` with one seed.
- an ``extenders:`` block through ``config/loader.py``: equal
  ``ExtenderConfig``s from both packages.
"""

import dataclasses
import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from kubernetes_tpu.api import serialization as jax_serialization
from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.apiserver import server as jax_server
from kubernetes_tpu.cache import node_info as jax_node_info
from kubernetes_tpu.client import client as jax_client
from kubernetes_tpu.client import informer as jax_informer
from kubernetes_tpu.config import loader as jax_loader
from kubernetes_tpu.scheduler import extender as jax_extender
from kubernetes_tpu.scheduler import scheduler as jax_scheduler
from kubernetes_tpu import testing as jax_testing
from kubernetes_tpu_torch.api import serialization as torch_serialization
from kubernetes_tpu_torch.api import types as torch_types
from kubernetes_tpu_torch.apiserver import server as torch_server
from kubernetes_tpu_torch.cache import node_info as torch_node_info
from kubernetes_tpu_torch.client import client as torch_client
from kubernetes_tpu_torch.client import informer as torch_informer
from kubernetes_tpu_torch.config import loader as torch_loader
from kubernetes_tpu_torch.scheduler import extender as torch_extender
from kubernetes_tpu_torch.scheduler import scheduler as torch_scheduler
from kubernetes_tpu_torch import testing as torch_testing


class Pkg:
    """One package's modules, under the same names."""

    def __init__(self, name, **mods):
        self.name = name
        self.__dict__.update(mods)
        self.kw = {"device": "cpu"} if name == "torch" else {}


NAMES = ("serialization", "types", "server", "node_info", "client",
         "informer", "loader", "extender", "scheduler", "testing")
PKGS = {
    "jax": Pkg("jax", **dict(zip(NAMES, (
        jax_serialization, jax_types, jax_server, jax_node_info, jax_client,
        jax_informer, jax_loader, jax_extender, jax_scheduler,
        jax_testing)))),
    "torch": Pkg("torch", **dict(zip(NAMES, (
        torch_serialization, torch_types, torch_server, torch_node_info,
        torch_client, torch_informer, torch_loader, torch_extender,
        torch_scheduler, torch_testing)))),
}
WIDGET = "example.com/widget"


class _ExtenderHandler(BaseHTTPRequestHandler):
    """``tests/test_extender.py``'s handler: the filter rejects a node
    named "forbidden" and every ``node-<i>`` with i a multiple of 5, the
    prioritize prefers "preferred" and every ``node-<i>`` with i = 1 mod
    5, the bind records its arguments and hands them to ``binder`` (the
    package's client, when a test binds for real)."""

    bindings = []
    binder = None

    def log_message(self, *a):  # silence
        pass

    @staticmethod
    def _index(name):
        return int(name[5:]) if name.startswith("node-") else -1

    def do_POST(self):
        length = int(self.headers["Content-Length"])
        args = json.loads(self.rfile.read(length))
        cache_capable = "nodenames" in args
        if cache_capable:
            names_in = args.get("nodenames", [])
        else:
            names_in = [
                n["metadata"]["name"]
                for n in args.get("nodes", {}).get("items", [])
            ]
        if self.path.endswith("/filter"):
            rejected = {n for n in names_in if n == "forbidden"
                        or self._index(n) % 5 == 0}
            names = [n for n in names_in if n not in rejected]
            failed = {n: "extender says no" for n in names_in
                      if n in rejected}
            if cache_capable:
                out = {"nodeNames": names, "failedNodes": failed}
            else:
                out = {
                    "nodes": {"items": [{"metadata": {"name": n}}
                                        for n in names]},
                    "failedNodes": failed,
                }
        elif self.path.endswith("/prioritize"):
            out = [
                {"host": n, "score": 10 if n == "preferred"
                 or self._index(n) % 5 == 1 else 0}
                for n in names_in
            ]
        elif self.path.endswith("/bind"):
            _ExtenderHandler.bindings.append(args)
            out = {}
            if _ExtenderHandler.binder is not None:
                try:
                    _ExtenderHandler.binder(args)
                except Exception as e:  # noqa: BLE001 - the wire's answer
                    out = {"error": str(e)}
        else:
            self.send_response(404)
            self.end_headers()
            return
        body = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def extender_server():
    _ExtenderHandler.bindings = []
    _ExtenderHandler.binder = None
    httpd = HTTPServer(("127.0.0.1", 0), _ExtenderHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}"
    httpd.shutdown()
    httpd.server_close()


def _ext(P, **cfg):
    return P.extender.HTTPExtender(P.extender.ExtenderConfig(**cfg))


# -- twins of tests/test_extender.py::TestHTTPExtender -------------------------


@pytest.mark.parametrize("cache_capable", [True, False])
def test_filter_and_prioritize(extender_server, cache_capable):
    out = {}
    for name, P in PKGS.items():
        ext = _ext(P, url_prefix=extender_server, filter_verb="filter",
                   prioritize_verb="prioritize", weight=2,
                   node_cache_capable=cache_capable)
        nodes = [P.node_info.NodeInfo(P.testing.make_node(n).obj())
                 for n in ("forbidden", "preferred")]
        pod = P.testing.make_pod("p").obj()
        feasible, failed = ext.filter(pod, nodes)
        assert [ni.node_name for ni in feasible] == ["preferred"], name
        assert "forbidden" in failed
        scores = ext.prioritize(pod, nodes)
        assert scores["preferred"] == 20  # weighted x2
        out[name] = ([ni.node_name for ni in feasible], dict(failed), scores)
    assert out["torch"] == out["jax"]


def test_managed_resources_interest(extender_server):
    out = {}
    for name, P in PKGS.items():
        ext = _ext(P, url_prefix=extender_server, filter_verb="filter",
                   managed_resources=["example.com/fpga"])
        mk = P.testing.make_pod
        plain = mk("plain").container(cpu="1").obj()
        special = mk("special").container(
            cpu="1", **{"example_com__fpga": 1}).obj()
        out[name] = (ext.is_interested(plain), ext.is_interested(special))
    assert out["torch"] == out["jax"] == (False, True)


def test_ignorable_extender_error_passthrough():
    out = {}
    for name, P in PKGS.items():
        ext = _ext(P, url_prefix="http://127.0.0.1:1",  # nothing listening
                   filter_verb="filter", ignorable=True)
        nodes = [P.node_info.NodeInfo(P.testing.make_node("n").obj())]
        feasible, failed = ext.filter(P.testing.make_pod("p").obj(), nodes)
        out[name] = ([ni.node_name for ni in feasible], dict(failed))
    assert out["torch"] == out["jax"] == (["n"], {})


def test_non_ignorable_extender_error_raises():
    raised = {}
    for name, P in PKGS.items():
        ext = _ext(P, url_prefix="http://127.0.0.1:1", filter_verb="filter")
        with pytest.raises(Exception) as info:
            ext.filter(P.testing.make_pod("p").obj(),
                       [P.node_info.NodeInfo(P.testing.make_node("n").obj())])
        raised[name] = type(info.value).__name__
    assert raised["torch"] == raised["jax"]


# -- twin of tests/test_extender.py::TestEndToEndWithExtender ------------------


def test_extender_steers_scheduling_and_binds(extender_server):
    chosen = {}
    for name, P in PKGS.items():
        _ExtenderHandler.bindings = []
        server = P.server.APIServer()
        client = P.client.Client(server)
        informers = P.informer.InformerFactory(server)
        cfg = P.extender.ExtenderConfig(
            url_prefix=extender_server, filter_verb="filter",
            prioritize_verb="prioritize", bind_verb="bind", weight=100)
        sched = P.scheduler.new_scheduler(client, informers,
                                          extenders=[cfg], **P.kw)
        for n in ("forbidden", "preferred", "other"):
            client.create_node(
                P.testing.make_node(n).capacity(cpu="8", memory="16Gi").obj())
        informers.start()
        informers.wait_for_cache_sync()
        client.create_pod(P.testing.make_pod("p").container(cpu="1").obj())
        sched.start()
        deadline = time.time() + 10
        while time.time() < deadline and not _ExtenderHandler.bindings:
            time.sleep(0.05)
        sched.stop()
        informers.stop()
        assert _ExtenderHandler.bindings, f"{name}: bind verb never called"
        chosen[name] = _ExtenderHandler.bindings[0]["node"]
    assert chosen["torch"] == chosen["jax"] == "preferred"


# -- twins of tests/test_extender.py::TestWireFormat ---------------------------


def _wire(P, pod):
    return (json.dumps(P.extender._pod_to_wire(pod), sort_keys=True),
            json.dumps(P.serialization.pod_to_dict(pod), sort_keys=True))


def test_pod_wire_carries_full_spec():
    wires = {}
    for name, P in PKGS.items():
        pod = (P.testing.make_pod("wire", "prod").uid("uid-wire")
               .labels(app="db").container(cpu="250m", memory="512Mi").obj())
        pod.spec.node_selector = {"disktype": "ssd"}
        wire = P.extender._pod_to_wire(pod)
        assert wire["metadata"]["name"] == "wire"
        spec = wire["spec"]
        assert spec["nodeSelector"] == {"disktype": "ssd"}
        c = spec["containers"][0]
        assert c["resources"]["requests"]["cpu"] == "250m"
        assert c["resources"]["requests"]["memory"] == str(512 * 1024 * 1024)
        wires[name] = _wire(P, pod)
    assert wires["torch"] == wires["jax"]


def test_pod_wire_serializes_affinity():
    wires = {}
    for name, P in PKGS.items():
        pod = (P.testing.make_pod("aff").uid("uid-aff")
               .pod_affinity("zone", {"app": "db"}, anti=True).obj())
        wire = P.extender._pod_to_wire(pod)
        terms = wire["spec"]["affinity"]["podAntiAffinity"][
            "requiredDuringSchedulingIgnoredDuringExecution"
        ]
        assert terms[0]["topologyKey"] == "zone"
        assert terms[0]["labelSelector"]["matchLabels"] == {"app": "db"}
        wires[name] = _wire(P, pod)
    assert wires["torch"] == wires["jax"]


# -- the batch path with a binder extender -------------------------------------


def _batch_with_extender(P, url, seed=0):
    """40 nodes of 8 CPU and 4 widgets; 60 pods of 250m-1 CPU, every
    fifth requesting one widget, all pending before one batch pops them;
    the extender filters, prioritizes (weight 5) and binds the widget
    pods through the package's client."""
    server = P.server.APIServer()
    client = P.client.Client(server)
    informers = P.informer.InformerFactory(server)
    cfg = P.extender.ExtenderConfig(
        url_prefix=url, filter_verb="filter", prioritize_verb="prioritize",
        bind_verb="bind", weight=5, node_cache_capable=True,
        managed_resources=[WIDGET])
    sched = P.scheduler.new_scheduler(
        client, informers, batch=True, max_batch=64, extenders=[cfg],
        rng=random.Random(seed), **P.kw)

    def bind(args):
        client.bind(P.types.Binding(
            pod_namespace=args["podNamespace"], pod_name=args["podName"],
            pod_uid=args["podUID"], target_node=args["node"]))

    _ExtenderHandler.bindings = []
    _ExtenderHandler.binder = bind
    for i in range(40):
        client.create_node(P.testing.make_node(f"node-{i}").capacity(
            cpu="8", memory="32Gi", pods=110, example_com__widget=4).obj())
    rng = random.Random(7)
    names = [f"p{i}" for i in range(60)]
    for i, nm in enumerate(names):
        w = P.testing.make_pod(nm).container(
            cpu=f"{rng.choice((250, 500, 1000))}m", memory="256Mi",
            **({"example_com__widget": 1} if i % 5 == 4 else {}))
        client.create_pod(w.obj())
    informers.start()
    informers.wait_for_cache_sync()
    try:
        deadline = time.time() + 30
        while sched.queue.num_pending()["active"] < 60:
            assert time.time() < deadline
            time.sleep(0.01)
        assert sched.schedule_batch(timeout=5) == 60
        sched.wait_for_inflight_binds(timeout=30)
        deadline = time.time() + 30
        while time.time() < deadline:
            placed = {p.metadata.name: p.spec.node_name
                      for p in client.list_pods()[0]}
            if all(placed.values()):
                break
            time.sleep(0.05)
        # uids come from a process-wide counter: the name and the node
        # are what the two packages decide
        binds = [(b["podName"], b["node"]) for b in _ExtenderHandler.bindings]
        return placed, binds, sched.pods_fallback
    finally:
        _ExtenderHandler.binder = None
        sched.stop()
        informers.stop()


def test_batch_path_with_a_binder_extender_places_as_the_jax_package(
        extender_server):
    out = {name: _batch_with_extender(P, extender_server)
           for name, P in PKGS.items()}
    placed, bindings, fallback = out["torch"]
    widget = {f"p{i}" for i in range(4, 60, 5)}
    assert all(placed.values()), placed
    assert {nm for nm, _ in bindings} == widget
    assert len(bindings) == len(widget) == fallback
    for nm in widget:
        assert int(placed[nm][5:]) % 5 != 0, (nm, placed[nm])
    assert out["jax"][0] == placed
    assert out["jax"][1] == bindings and out["jax"][2] == fallback


def test_loader_parses_extenders_alike():
    raw = {"extenders": [
        {"urlPrefix": "http://127.0.0.1:8888/ext", "filterVerb": "filter",
         "prioritizeVerb": "prioritize", "bindVerb": "bind",
         "preemptVerb": "preempt", "weight": 5, "nodeCacheCapable": True,
         "ignorable": True,
         "managedResources": [{"name": WIDGET, "ignoredByScheduler": True}]},
        {"urlPrefix": "http://127.0.0.1:9999", "filterVerb": "filter"},
    ]}
    got = {name: [dataclasses.asdict(e) for e in
                  P.loader.load_config_from_dict(raw).extenders]
           for name, P in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["managed_resources"] == [WIDGET]
    assert got["torch"][0]["weight"] == 5
    assert got["torch"][1]["ignorable"] is False
