"""The score families, on the CPU, in both packages: preferred inter-pod
(anti-)affinity and the whole score surface at once.

Twins of ``tests/test_ipa_scoring_device.py`` and ``tests/
test_score_differential.py``, under the reference's seeds and sizes and
with the harness of ``tests/test_torch_constrained_families.py``: the
port's batch scheduler (``device="cpu"``) places pod for pod as the JAX
package's and as the port's sequential oracle (every node scored, the
first of tied nodes kept), every pod's admission record equals the JAX
package's, and no pod leaves the batch path. The surface mixes every
score family in one cluster: distinct capacities (the resource scores),
zones and a Service (selector spread), PreferNoSchedule taints
(TaintToleration), node images (ImageLocality), preferred node
affinity, soft topology spread, and preferred pod (anti-)affinity with
symmetric terms of existing pods; then hard zone spread scoped by node
pools.
"""

import random

import pytest

from test_torch_constrained_families import _three_ways

# -- preferred inter-pod affinity (tests/test_ipa_scoring_device.py) -----------

IPA_APPS = ["web", "db", "cache"]


def _ipa_cluster(seed):
    def build(P, server, client):
        rng = random.Random(seed)
        zones = ["z1", "z2", "z3", "z4"]
        for i in range(12):
            client.create_node(
                P["node"](f"n{i}")
                .labels(zone=zones[i % len(zones)], rack=f"r{i % 6}")
                .capacity(cpu=str(8 + 2 * i), memory=f"{24 + 5 * i}Gi").obj()
            )
        for j in range(10):
            w = (
                P["pod"](f"ex{j}").node(f"n{rng.randrange(12)}")
                .labels(app=rng.choice(IPA_APPS))
                .container(cpu="100m", memory="128Mi")
            )
            roll = rng.random()
            if roll < 0.3:
                w.preferred_pod_affinity(
                    "zone", {"app": rng.choice(IPA_APPS)},
                    weight=rng.choice([1, 5, 10]),
                )
            elif roll < 0.5:
                w.preferred_pod_affinity(
                    "zone", {"app": rng.choice(IPA_APPS)},
                    weight=rng.choice([1, 5]), anti=True,
                )
            elif roll < 0.65:
                w.pod_affinity("rack", {"app": rng.choice(IPA_APPS)})
            client.create_pod(w.obj())
        pods = []
        for i in range(12):
            w = (
                P["pod"](f"m{i}").labels(app=rng.choice(IPA_APPS))
                .creation_timestamp(float(i))
                .container(cpu="200m", memory="256Mi")
            )
            roll = rng.random()
            if roll < 0.4:
                w.preferred_pod_affinity(
                    "zone", {"app": rng.choice(IPA_APPS)},
                    weight=rng.choice([1, 5, 10]),
                )
            elif roll < 0.7:
                w.preferred_pod_affinity(
                    "rack", {"app": rng.choice(IPA_APPS)},
                    weight=rng.choice([1, 5]), anti=True,
                )
            pods.append(w.obj())
        return pods, 10
    return build


def _all_on_device(run):
    got, sched, adm, _ = run
    assert sched.pods_fallback == 0
    assert all(device_ok for device_ok, _, _ in adm.values()), adm
    return got


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_preferred_affinity_batch_places_as_the_oracle(seed):
    got = _all_on_device(_three_ways(_ipa_cluster(seed), pct=100))
    assert all(got.values())


def _two_zones(pods, existing=()):
    def build(P, server, client):
        for name, zone in (("a", "z1"), ("b", "z2")):
            client.create_node(
                P["node"](name).labels(zone=zone)
                .capacity(cpu="8", memory="16Gi").obj()
            )
        for make in existing:
            client.create_pod(make(P["pod"]))
        return [make(P["pod"]) for make in pods], len(existing)
    return build


def test_preferred_affinity_attracts_within_a_batch():
    pods = [
        lambda mk: mk("leader").labels(app="db").priority(10)
        .creation_timestamp(0.0).container(cpu="100m", memory="128Mi").obj(),
        lambda mk: mk("follower").labels(app="web").creation_timestamp(1.0)
        .container(cpu="100m", memory="128Mi")
        .preferred_pod_affinity("zone", {"app": "db"}, weight=100).obj(),
    ]
    got = _all_on_device(_three_ways(_two_zones(pods), max_batch=32))
    assert got["leader"] and got["follower"] == got["leader"]


def test_preferred_anti_affinity_repels_within_a_batch():
    pods = [
        (lambda mk, i=i: mk(f"p{i}").labels(app="db")
         .creation_timestamp(float(i)).container(cpu="100m", memory="128Mi")
         .preferred_pod_affinity("zone", {"app": "db"}, weight=100,
                                 anti=True).obj())
        for i in range(2)
    ]
    got = _all_on_device(_three_ways(_two_zones(pods), max_batch=32))
    assert len(set(got.values())) == 2


def test_an_existing_pods_symmetric_term_scores_a_plain_batch():
    magnet = (lambda mk: mk("magnet").node("a").labels(app="db")
              .container(cpu="100m", memory="128Mi")
              .preferred_pod_affinity("zone", {"app": "web"}, weight=100)
              .obj())
    pods = [lambda mk: mk("plain").labels(app="web")
            .container(cpu="100m", memory="128Mi").obj()]
    got = _all_on_device(
        _three_ways(_two_zones(pods, existing=[magnet]), max_batch=32)
    )
    assert got["plain"] == "a"


# -- the whole score surface (tests/test_score_differential.py) ----------------


def _surface(seed):
    def build(P, server, client):
        T = P["types"]
        rng = random.Random(seed)
        zones = ["z1", "z2", "z3"]
        for i in range(10):
            w = (
                P["node"](f"n{i}")
                .labels(zone=zones[i % 3], disk="ssd" if i % 4 == 0 else "hdd")
                .capacity(cpu=str(6 + 3 * i), memory=f"{16 + 7 * i}Gi")
            )
            if i % 5 == 2:
                w.taint("best-effort", "true", effect="PreferNoSchedule")
            if i % 3 == 1:
                w.image("registry/app:v1", (i + 1) * 100_000_000)
            client.create_node(w.obj())
        server.create(T.Service(
            metadata=T.ObjectMeta(name="web", namespace="default"),
            selector={"app": "web"},
        ))
        for j in range(8):
            w = (
                P["pod"](f"ex{j}").node(f"n{rng.randrange(10)}")
                .labels(app=rng.choice(IPA_APPS))
                .container(cpu="100m", memory="128Mi")
            )
            if rng.random() < 0.4:
                w.preferred_pod_affinity(
                    "zone", {"app": rng.choice(IPA_APPS)},
                    weight=rng.choice([1, 7]), anti=rng.random() < 0.5,
                )
            client.create_pod(w.obj())
        pods = []
        for i in range(14):
            w = (
                P["pod"](f"m{i}").labels(app=rng.choice(IPA_APPS))
                .creation_timestamp(float(i))
                .container(
                    cpu=f"{rng.choice([100, 300, 700])}m",
                    memory=f"{rng.choice([128, 384])}Mi",
                    image="registry/app:v1" if rng.random() < 0.4 else "",
                )
            )
            roll = rng.random()
            if roll < 0.25:
                w.preferred_node_affinity_in("disk", ["ssd"],
                                             weight=rng.choice([1, 5]))
            elif roll < 0.45:
                w.preferred_pod_affinity(
                    "zone", {"app": rng.choice(IPA_APPS)},
                    weight=rng.choice([1, 9]), anti=rng.random() < 0.4,
                )
            elif roll < 0.6:
                w.spread_constraint(
                    2, "zone", when_unsatisfiable="ScheduleAnyway",
                    match_labels={"app": "web"},
                )
            elif roll < 0.7:
                w.toleration("best-effort", value="true")
            pods.append(w.obj())
        return pods, 8
    return build


@pytest.mark.parametrize("seed", [2, 13, 37, 71])
def test_the_full_score_surface_places_as_the_oracle(seed):
    got = _three_ways(_surface(seed), pct=100)[0]
    assert all(got.values())


def _scoped_spread(seed):
    def build(P, server, client):
        rng = random.Random(seed)
        for i in range(18):
            client.create_node(
                P["node"](f"n{i}").capacity(cpu="8", memory="16Gi", pods=20)
                .labels(zone=f"z{i % 3}", pool="a" if i % 2 == 0 else "b")
                .obj()
            )
        for i in range(5):
            client.create_pod(
                P["pod"](f"ex{i}").labels(app="web")
                .container(cpu="100m", memory="128Mi").node(f"n{i}").obj()
            )
        pods = []
        for i in range(20):
            w = (P["pod"](f"m{i}").labels(app="web")
                 .creation_timestamp(float(i))
                 .container(cpu="100m", memory="128Mi"))
            roll = rng.random()
            if roll < 0.4:
                w.spread_constraint(
                    1, "zone", when_unsatisfiable="DoNotSchedule",
                    match_labels={"app": "web"},
                ).node_selector(pool="a")
            elif roll < 0.6:
                w.spread_constraint(
                    1, "zone", when_unsatisfiable="DoNotSchedule",
                    match_labels={"app": "web"},
                ).node_selector(pool="b")
            elif roll < 0.8:
                w.spread_constraint(
                    2, "zone", when_unsatisfiable="DoNotSchedule",
                    match_labels={"app": "web"},
                )
            pods.append(w.obj())
        return pods, 5
    return build


@pytest.mark.parametrize("seed", [3, 17, 53])
def test_hard_spread_scoped_by_node_pools_places_as_the_oracle(seed):
    _all_on_device(_three_ways(_scoped_spread(seed), pct=100))
