"""The port's solver ladder, host-greedy tier, informer relist and config
surface against the JAX package's, on the CPU: twins of the cases of
``tests/test_robustness.py`` that reach code the port rewrote.

Not twinned: ``TestFaultInjector``, ``TestCircuitBreaker``,
``TestWatchdog`` and ``TestRetryPolicy``. ``robustness/faults.py``,
``robustness/circuit.py`` (the breaker, the watchdog, ``RetryPolicy``)
and ``client/informer.py`` are byte-identical in both packages apart from
the package name in their imports (and, in the port's informer, the
``ingest`` trace span, covered by ``tests/test_torch_trace_spans.py``),
so the reference's own cases already run their code.

How the tiers map. The reference's device tiers are ``pallas`` and
``xla``; its ``TestSolverLadder`` drives ``xla`` above ``host_greedy``.
On the CPU the port's one device tier is ``torch`` (the kernels' plain
versions), offered above the same ``host_greedy`` and ``sequential``
tiers. Each ladder case runs with ``xla`` in the JAX package and
``torch`` in the port, and compares, with the tier names mapped: the
tier that answered and its result, ``solves_by_tier``, every breaker's
state and the transitions counted in
``scheduler_circuit_breaker_transitions_total``, the fallbacks counted in
``scheduler_solver_fallback_total`` (tier and reason) and the retries in
``scheduler_solve_retries_total``. Tolerance: exact.

On the card the only tier is ``cuda``, with no breaker and no CPU tier
below it (``robustness/ladder.py``). Every ladder case also runs with its
device tier named ``cuda``, and its answer is written down beside the
reference's: a real fault raises at once where the reference steps down
or exhausts; an open breaker never skips the card; a hang raises its
``SolveTimeout`` unless the injector hung that attempt, and then it is
retried in place and ends in ``LadderExhausted`` caused by a
``FaultInjected``. No case relies on two device tiers: ``pallas`` never
appears in the reference's ladder cases.

``TestHostGreedyParity``: the port's ``host_greedy_assign`` against the
JAX package's and against its device solve (``greedy_assign_compact``),
bit for bit, at three seeds. ``TestInformerRelist``: a watch drop
mid-burst through each package's batch scheduler (the port on
``device="cpu"``), every pod bound alike and one relist counted per
drop. ``TestConfigSurface``: the same YAML dict through each package's
``load_config_from_dict`` and ``new_scheduler_from_config``: the ladder's
knobs, the installed injector's profile, the validation errors.
"""

import time

import numpy as np
import pytest

import kubernetes_tpu.apiserver.server as jax_server
import kubernetes_tpu.client.client as jax_client
import kubernetes_tpu.client.informer as jax_informer
import kubernetes_tpu.config.loader as jax_loader
import kubernetes_tpu.config.validation as jax_validation
import kubernetes_tpu.robustness.circuit as jax_circuit
import kubernetes_tpu.robustness.faults as jax_faults
import kubernetes_tpu.robustness.ladder as jax_ladder
import kubernetes_tpu.scheduler.scheduler as jax_sched
import kubernetes_tpu.testing as jax_testing
import kubernetes_tpu.utils.metrics as jax_metrics
import kubernetes_tpu_torch.apiserver.server as port_server
import kubernetes_tpu_torch.client.client as port_client
import kubernetes_tpu_torch.client.informer as port_informer
import kubernetes_tpu_torch.config.loader as port_loader
import kubernetes_tpu_torch.config.validation as port_validation
import kubernetes_tpu_torch.robustness.circuit as port_circuit
import kubernetes_tpu_torch.robustness.faults as port_faults
import kubernetes_tpu_torch.robustness.ladder as port_ladder
import kubernetes_tpu_torch.scheduler.scheduler as port_sched
import kubernetes_tpu_torch.testing as port_testing
import kubernetes_tpu_torch.utils.metrics as port_metrics


class P:
    """One package's modules, and the name of its device tier here."""

    def __init__(self, pkg, tier=None):
        self.pkg = pkg
        if pkg == "jax":
            (self.server, self.client, self.informer, self.loader,
             self.validation, self.circuit, self.faults, self.ladder,
             self.sched, self.testing, self.metrics) = (
                jax_server, jax_client, jax_informer, jax_loader,
                jax_validation, jax_circuit, jax_faults, jax_ladder,
                jax_sched, jax_testing, jax_metrics)
            self.tier = tier or jax_ladder.TIER_XLA
            self.kw = {}
        else:
            (self.server, self.client, self.informer, self.loader,
             self.validation, self.circuit, self.faults, self.ladder,
             self.sched, self.testing, self.metrics) = (
                port_server, port_client, port_informer, port_loader,
                port_validation, port_circuit, port_faults, port_ladder,
                port_sched, port_testing, port_metrics)
            self.tier = tier or port_ladder.TIER_TORCH
            self.kw = {"device": "cpu"}


JAX, PORT, CARD = ("jax", None), ("torch", None), ("torch", "cuda")


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    jax_faults.install_injector(None)
    port_faults.install_injector(None)


# -- TestSolverLadder -----------------------------------------------------------


class _Moves:
    """The ladder counters' growth over one case, with the package's
    device tier written ``DEV``."""

    COUNTERS = ("breaker_transitions", "solver_fallbacks", "solve_retries")

    def __init__(self, p):
        self.p = p
        self.before = {c: dict(getattr(p.metrics, c)._values)
                       for c in self.COUNTERS}

    def moved(self):
        out = {}
        for c in self.COUNTERS:
            vals = getattr(self.p.metrics, c)._values
            for key, v in vals.items():
                d = v - self.before[c].get(key, 0.0)
                if d:
                    labels = tuple((k, _dev(val, self.p.tier))
                                   for k, val in key)
                    out[(c, labels)] = d
        return out


def _dev(x, tier):
    """``x`` with the device tier's name written ``DEV`` (a fallback
    reason is prefixed with it: ``xla_error`` / ``torch_error``)."""
    if isinstance(x, tuple):
        return tuple(_dev(v, tier) for v in x)
    if x == tier:
        return "DEV"
    if isinstance(x, str) and x.startswith(tier + "_"):
        return "DEV" + x[len(tier):]
    return x


def _ladder(p, **kw):
    """The reference case's ladder (``tests/test_robustness.py:211``)."""
    kw.setdefault("solve_timeout_seconds", 2.0)
    kw.setdefault("cooloff_seconds", 0.2)
    kw.setdefault("failure_threshold", 1)
    kw.setdefault("retry", p.circuit.RetryPolicy(max_attempts=1))
    kw.setdefault("sleep", lambda s: None)
    return p.ladder.SolverLadder(p.ladder.RobustnessConfig(**kw))


def _boom():
    raise RuntimeError("device down")


def _first_tier_wins(p):
    lad = _ladder(p)
    return lad, lad.run([(p.tier, lambda: "ok")])


def _steps_down_on_error(p):
    lad = _ladder(p)
    return lad, lad.run([(p.tier, _boom), ("host_greedy", lambda: "host")])


def _open_breaker_skips_tier(p):
    lad = _ladder(p)
    calls = []

    def never():
        calls.append(1)
        return "x"

    if p.tier in lad.breakers:
        lad.breakers[p.tier].force_open()
    out = lad.run([(p.tier, never), ("host_greedy", lambda: "host")])
    return lad, (out, len(calls))


def _exhaustion_raises(p):
    lad = _ladder(p)
    return lad, lad.run([(p.tier, _boom)])


def _retry_in_place(p):
    lad = _ladder(p, retry=p.circuit.RetryPolicy(max_attempts=3))
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return "ok"

    out = lad.run([(p.tier, flaky)])
    return lad, (out, len(attempts))


def _timeout_steps_down(p):
    lad = _ladder(p, solve_timeout_seconds=0.1)
    return lad, lad.run([
        (p.tier, lambda: time.sleep(0.3) or "late"),
        ("host_greedy", lambda: "host"),
    ])


def _breaker_closes_after_cooloff(p):
    lad = _ladder(p, cooloff_seconds=0.05)
    first = lad.run([(p.tier, _boom), ("host_greedy", lambda: "h")])
    opened = lad.breakers[p.tier].state if p.tier in lad.breakers else None
    time.sleep(0.1)
    second = lad.run([(p.tier, lambda: "back"), ("host_greedy", lambda: "h")])
    return lad, (first, opened, second)


LADDER_CASES = {
    "first_tier_wins": _first_tier_wins,
    "steps_down_on_error": _steps_down_on_error,
    "open_breaker_skips_tier": _open_breaker_skips_tier,
    "exhaustion_raises": _exhaustion_raises,
    "retry_in_place_before_stepping_down": _retry_in_place,
    "timeout_force_opens_and_steps_down": _timeout_steps_down,
    "breaker_closes_after_cooloff_probe": _breaker_closes_after_cooloff,
}


def _run_case(case, which):
    """One ladder case through a package: its answer (or the type of what
    it raised), the ladder's state after it and the counters it moved,
    tier names mapped to ``DEV``."""
    p = P(*which)
    moves = _Moves(p)
    lad = None
    try:
        lad, answer = LADDER_CASES[case](p)
    except Exception as e:  # noqa: BLE001 - the answer under comparison
        answer = ("raised", type(e).__name__,
                  type(e.__cause__).__name__ if e.__cause__ else None)

    state = None
    if lad is not None:
        breakers = {_dev(t, p.tier): b.state for t, b in lad.breakers.items()}
        # the reference's second device tier is never offered here: its
        # breaker must stay closed, and the port has no such tier
        assert breakers.pop("pallas", "closed") == "closed"
        state = (
            {_dev(t, p.tier): n for t, n in lad.solves_by_tier.items() if n},
            breakers,
        )
    return _dev(answer, p.tier), state, moves.moved()


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_ladder_answers_as_the_jax_package(case):
    """Each reference ladder case: the port's ``torch`` tier answers as
    the JAX package's ``xla`` tier, state and counters alike."""
    assert _run_case(case, PORT) == _run_case(case, JAX)


#: the card's answer to each reference ladder case, where it differs
CARD_ANSWERS = {
    "first_tier_wins": ("DEV", "ok"),
    # a real fault on the card raises at once, never steps down
    "steps_down_on_error": ("raised", "RuntimeError", None),
    # the card tier has no breaker to open: it is tried
    "open_breaker_skips_tier": (("DEV", "x"), 1),
    "exhaustion_raises": ("raised", "RuntimeError", None),
    # a real fault is not retried on the card
    "retry_in_place_before_stepping_down": ("raised", "RuntimeError", None),
    # a hang no injector made is the card's: it raises
    "timeout_force_opens_and_steps_down": ("raised", "SolveTimeout", None),
    "breaker_closes_after_cooloff_probe": ("raised", "RuntimeError", None),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_the_card_tier_answers_each_ladder_case(case):
    """The same cases with the device tier named ``cuda``: nothing steps
    down to a CPU tier, nothing is retried but an injected fault, and no
    breaker guards the card."""
    answer, state, moved = _run_case(case, CARD)
    assert answer == CARD_ANSWERS[case]
    if state is not None:
        assert "host_greedy" not in state[0]
        assert "DEV" not in state[1]
    assert not any(c == "solve_retries" for c, _ in moved)


def test_the_card_retries_an_injected_hang_then_exhausts():
    """A SolveTimeout whose attempt the injector hung is an injected
    fault on the card: retried in place, then LadderExhausted caused by a
    FaultInjected; the same timeout with no injected hang raises."""
    p = P(*CARD)
    lad = _ladder(p, solve_timeout_seconds=0.05,
                  retry=p.circuit.RetryPolicy(max_attempts=2))
    before = p.metrics.solve_retries.value(tier="cuda")
    calls = []

    def hung():
        calls.append(1)
        time.sleep(0.2)
        return "late"

    with pytest.raises(p.ladder.LadderExhausted) as exc:
        lad.run([("cuda", hung)], injected_hang=lambda: True)
    assert isinstance(exc.value.__cause__, p.faults.FaultInjected)
    assert exc.value.__cause__.point == "device_solve_hang"
    assert len(calls) == 2 and lad.injected_retries == 1
    assert p.metrics.solve_retries.value(tier="cuda") == before + 1
    with pytest.raises(p.circuit.SolveTimeout):
        lad.run([("cuda", hung)], injected_hang=lambda: False)
    assert len(calls) == 3
    # on the CPU's device tier the reference's answer stands: step down
    cpu = _ladder(P(*PORT), solve_timeout_seconds=0.05)
    assert cpu.run([("torch", hung), ("host_greedy", lambda: "h")],
                   injected_hang=lambda: True) == ("host_greedy", "h")


# -- TestHostGreedyParity -------------------------------------------------------


def _parity_inputs(seed):
    """``tests/test_robustness.py:308``'s inputs at ``seed``."""
    rng = np.random.default_rng(seed)
    n, r, b_sz = 16, 5, 24
    allocatable = np.zeros((n, r), dtype=np.int32)
    allocatable[:, 0] = rng.integers(4000, 16000, n)
    allocatable[:, 1] = rng.integers(1 << 20, 1 << 22, n)
    allocatable[:, 3] = 110
    requested = np.zeros_like(allocatable)
    nzr = np.zeros((n, 2), dtype=np.int32)
    valid = np.ones(n, dtype=bool)
    pod_req = np.zeros((b_sz, r), dtype=np.int32)
    pod_req[:, 0] = rng.integers(100, 2000, b_sz)
    pod_req[:, 1] = rng.integers(1 << 14, 1 << 17, b_sz)
    pod_req[:, 3] = 1
    pod_nzr = pod_req[:, :2].copy()
    mask_rows = np.ones((2, n), dtype=bool)
    mask_rows[1, : n // 2] = False
    mask_index = rng.integers(0, 2, b_sz).astype(np.int32)
    active = np.ones(b_sz, dtype=bool)
    active[-2:] = False
    return (allocatable, requested, nzr, valid, pod_req, pod_nzr,
            mask_rows, mask_index, active)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_greedy_matches_the_jax_host_tier_and_device_solve(seed):
    """The port's host tier replays the JAX package's host tier and its
    device scan bit for bit (assignments, requested', nzr')."""
    import jax.numpy as jnp

    from kubernetes_tpu.ops.assignment import GreedyConfig as JaxConfig
    from kubernetes_tpu.ops.assignment import greedy_assign_compact
    from kubernetes_tpu_torch.ops.assignment import GreedyConfig

    args = _parity_inputs(seed)
    port = port_ladder.host_greedy_assign(*args, config=GreedyConfig())
    host = jax_ladder.host_greedy_assign(*args, config=JaxConfig())
    dev = greedy_assign_compact(*(jnp.asarray(a) for a in args),
                                config=JaxConfig())
    assert (port[0] >= 0).sum() > 0
    for a, b, c in zip(port, host, dev):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))


# -- TestInformerRelist ---------------------------------------------------------


def _relist_burst(which):
    """Two waves through a batch scheduler driven by hand, a guaranteed
    watch drop between them: the placements, the relists counted and the
    informer's view after one more pump."""
    p = P(*which)
    server = p.server.APIServer()
    client = p.client.Client(server)
    informers = p.informer.InformerFactory(server)
    sched = p.sched.new_scheduler(client, informers, batch=True,
                                  max_batch=16, **p.kw)
    sched.batch_window = 0.0
    for i in range(4):
        client.create_node(p.testing.make_node(f"n{i}").capacity(
            cpu="8", memory="16Gi", pods=30).obj())
    informers.pump()

    def wave(prefix, n):
        for i in range(n):
            client.create_pod(p.testing.make_pod(f"{prefix}{i}").container(
                cpu="500m", memory="256Mi").obj())

    def drive():
        for _ in range(10):
            if not sched.schedule_batch(timeout=0.05, pipeline=False):
                break
            informers.pump()

    wave("a", 12)
    informers.pump()
    drive()
    wave("b", 12)
    client.delete_pod("default", "a0")
    before = p.metrics.watch_relists.value(kind="Pod")
    p.faults.install_injector(p.faults.FaultInjector(p.faults.FaultProfile(
        "t", points={p.faults.FaultPoint.WATCH_DROP:
                     p.faults.PointConfig(rate=1.0, max_fires=1)})))
    informers.pods().pump()  # the drop fires: relist
    p.faults.install_injector(None)
    relists = p.metrics.watch_relists.value(kind="Pod") - before
    informers.pump()
    drive()
    sched.wait_for_inflight_binds()
    informers.pump()
    seen = sorted(x.metadata.name for x in informers.pods().list())
    placed = sorted((x.metadata.name, x.spec.node_name)
                    for x in client.list_pods()[0])
    sched.stop()
    return relists, seen, placed, sched.cache.pod_count()


def test_relist_after_a_watch_drop_reconverges_through_the_scheduler():
    """``tests/test_robustness.py:350`` through each package's batch
    scheduler: the drop forces one relist, the informer converges on the
    apiserver (a0 deleted, the b wave seen), and every pod of both waves
    binds where the JAX package binds it."""
    port = _relist_burst(PORT)
    jax = _relist_burst(JAX)
    assert port == jax
    relists, seen, placed, cached = port
    assert relists == 1
    assert "a0" not in seen and len(seen) == 23
    assert all(node for _, node in placed) and cached == 23


# -- TestConfigSurface ----------------------------------------------------------


SURFACE = {
    "robustness": {
        "solveTimeout": "30s", "failureThreshold": 5, "cooloff": "2s",
        "probeBatches": 2, "retryMaxAttempts": 4, "retryBackoff": "10ms",
    },
    "faultInjection": {
        "enabled": True, "profile": "chaos-default", "seed": 42,
        "points": {
            "device_solve": {"rate": 0.5, "maxFires": 7},
            "device_solve_hang": {"rate": 0.1, "hangSeconds": "1500ms"},
        },
    },
}


def _surface(which, cfg_dict):
    """The dict through the package's config entry point: the built
    scheduler's ladder knobs and installed injector."""
    p = P(*which)
    cfg = p.loader.load_config_from_dict(cfg_dict)
    server = p.server.APIServer()
    sched = p.sched.new_scheduler_from_config(
        p.client.Client(server), p.informer.InformerFactory(server), cfg,
        **p.kw)
    rc = sched.ladder.config
    inj = p.faults.get_injector()
    sched.stop()
    return dict(
        ladder=(rc.enabled, rc.solve_timeout_seconds, rc.failure_threshold,
                rc.cooloff_seconds, rc.probe_batches, rc.retry.max_attempts,
                rc.retry.backoff_seconds, rc.retry.max_backoff_seconds),
        # the reference's pallas tier has no counterpart in the port
        breakers=sorted(
            (_dev(t, p.tier), b.failure_threshold)
            for t, b in sched.ladder.breakers.items() if t != "pallas"),
        injector=None if inj is None else (
            inj.profile.name, inj.profile.seed,
            sorted((k, v.rate, v.max_fires, v.hang_seconds)
                   for k, v in inj.profile.points.items())),
    )


@pytest.mark.parametrize("cfg", [SURFACE, {}], ids=["knobs", "defaults"])
def test_config_surface_builds_the_same_ladder(cfg):
    """``TestConfigSurface``'s dict through each package's
    ``new_scheduler_from_config``: the same ladder knobs and breakers, the
    same injector installed (``chaos-default``'s points kept where not
    overridden), none when injection is off."""
    port = _surface(PORT, cfg)
    jax = _surface(JAX, cfg)
    assert port == jax
    if cfg:
        assert port["ladder"][1:7] == (30.0, 5, 2.0, 2, 4, 0.01)
        assert port["injector"][:2] == ("chaos-default", 42)
        assert ("bind_conflict", 1.0, 3, 0.0) in port["injector"][2]
        assert ("device_solve", 0.5, 7, 0.0) in port["injector"][2]
    else:
        assert port["injector"] is None


def test_config_surface_rejects_bad_knobs_at_build():
    """The reference's bad knobs: the same validation errors, and each
    package's build refuses the configuration."""
    bad = {
        "robustness": {"failureThreshold": 0},
        "faultInjection": {
            "enabled": True, "profile": "not-a-profile",
            "points": {"bogus_point": {"rate": 2.0}},
        },
    }
    errors = {}
    for which in (PORT, JAX):
        p = P(*which)
        cfg = p.loader.load_config_from_dict(bad)
        errors[p.pkg] = p.validation.validate_config(cfg)
        server = p.server.APIServer()
        with pytest.raises(ValueError, match="failureThreshold"):
            p.sched.new_scheduler_from_config(
                p.client.Client(server), p.informer.InformerFactory(server),
                cfg, **p.kw)
    assert errors["torch"] == errors["jax"]
    for want in ("failureThreshold", "not-a-profile", "bogus_point", "rate"):
        assert any(want in e for e in errors["torch"])
