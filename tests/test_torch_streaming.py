"""The port's open-loop streaming plane against the JAX package's.

``kubernetes_tpu_torch/streaming/`` is the JAX package's streaming plane
carried over: the seeded arrival traces, the paced ``ArrivalEngine``
with its backpressure gate, and the SLO-adaptive ``AutoBatchController``.
The same seeds must give the same traces in both packages, and the
controller must take the same window/cap trajectory on the same
scripted inputs (grow, shrink, the overload latch, the rung ladder and
its calibration). The config wiring is held on the port alone:
``new_scheduler_from_config`` with a ``streaming:`` block attaches the
controller to the batch scheduler on ``device="cpu"``, warmup times one
solve per rung when the controller sizes its ladder from them, and a
steady Poisson trace through the real stack converges without the
controller thrashing.
"""

import time

import numpy as np
import pytest

from kubernetes_tpu.streaming import arrivals as jax_arrivals
from kubernetes_tpu.streaming.autobatch import (
    AutoBatchController as JaxController,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.config.loader import load_config_from_dict
from kubernetes_tpu_torch.config.validation import validate_config
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.scheduler.scheduler import (
    new_scheduler,
    new_scheduler_from_config,
)
from kubernetes_tpu_torch.streaming import arrivals
from kubernetes_tpu_torch.streaming.arrivals import (
    ArrivalEngine,
    load_trace,
    poisson_trace,
    replay_trace,
    save_trace,
)
from kubernetes_tpu_torch.streaming.autobatch import AutoBatchController
from kubernetes_tpu_torch.testing import make_node, make_pod


# -- trace generators, both packages ---------------------------------------


TRACES = [
    ("poisson", (1000.0, 5.0), {"seed": 42}),
    ("poisson", (2000.0, 10.0), {"seed": 7}),
    ("poisson", (0.0, 5.0), {}),
    ("bursty", (200.0, 2000.0, 20.0), {"seed": 5}),
    ("bursty", (300.0, 900.0, 8.0), {"seed": 29, "base_dwell": 2.0}),
    ("diurnal", (1000.0, 30.0), {"seed": 3, "period": 10.0}),
    ("diurnal", (250.0, 12.0), {"seed": 31, "trough_fraction": 0.4}),
]


@pytest.mark.parametrize(
    "kind,args,kw", TRACES,
    ids=[f"{k}-{i}" for i, (k, _, _) in enumerate(TRACES)],
)
def test_traces_equal_the_jax_package(kind, args, kw):
    fn = f"{kind}_trace"
    ours = getattr(arrivals, fn)(*args, **kw)
    theirs = getattr(jax_arrivals, fn)(*args, **kw)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype
    assert np.all(np.diff(ours) >= 0)


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
@pytest.mark.parametrize("seed", [0, 11, 31])
def test_load_trace_equals_the_jax_package(kind, seed):
    np.testing.assert_array_equal(
        load_trace(kind, 300.0, 4.0, seed),
        jax_arrivals.load_trace(kind, 300.0, 4.0, seed),
    )


def test_trace_from_config_equals_the_jax_package():
    """The perf matrix's DrainViaPreemption/500 trace (Poisson, 300
    pods/s, seed 31) and PreemptionCascade/500's (MMPP, 250, seed 29),
    sized to 500 pods as the runner sizes them."""
    for block in (
        {"trace": "poisson", "rate": 300, "seed": 31, "sloP99": "5s"},
        {"trace": "bursty", "rate": 250, "seed": 29, "sloP99": "10s"},
    ):
        cfg = load_config_from_dict({"streaming": {"enabled": True, **block}})
        ours = arrivals.trace_from_config(cfg.streaming, duration=2.0)
        theirs = jax_arrivals.trace_from_config(cfg.streaming, duration=2.0)
        np.testing.assert_array_equal(ours, theirs)
        assert ours.size > 0


def test_poisson_rate_and_bounds():
    offs = poisson_trace(2000.0, 10.0, seed=7)
    # n ~ Poisson(20000): 6 sigma is ~850
    assert abs(offs.size - 20000) < 1000
    assert offs[0] >= 0.0 and offs[-1] < 10.0


def test_replay_roundtrip_and_dispatch(tmp_path):
    offs = poisson_trace(500.0, 2.0, seed=1)
    p = str(tmp_path / "trace.json")
    save_trace(p, offs, kind="poisson", seed=1)
    np.testing.assert_allclose(replay_trace(p), offs)
    np.testing.assert_allclose(jax_arrivals.replay_trace(p), offs)
    assert load_trace("replay", 0.0, 0.0, replay_path=p).size == offs.size
    with pytest.raises(ValueError):
        load_trace("lognormal", 100.0, 1.0)
    with pytest.raises(ValueError):
        load_trace("replay", 100.0, 1.0)  # no path


# -- arrival engine ---------------------------------------------------------


class _StubClient:
    """create_pods_bulk sink; no apiserver."""

    def __init__(self):
        self.created = []

    def create_pods_bulk(self, pods):
        self.created.extend(pods)
        return pods


def test_engine_replays_full_trace_and_stamps_created_ts():
    stub = _StubClient()
    eng = ArrivalEngine(
        stub, np.linspace(0.0, 0.2, 50), lambda i: make_pod(f"a-{i}").obj()
    )
    eng.start()
    assert eng.join(timeout=10.0)
    assert eng.created == 50 and len(stub.created) == 50
    assert set(eng.created_ts) == {f"a-{i}" for i in range(50)}


def test_engine_backpressure_stalls_instead_of_unbounded_growth():
    stub = _StubClient()
    drained = [0]

    def depth():
        return len(stub.created) - drained[0]

    eng = ArrivalEngine(
        stub, np.linspace(0.0, 0.05, 400),
        lambda i: make_pod(f"b-{i}").obj(),
        depth_fn=depth, max_queue_depth=64,
    )
    eng.start()
    time.sleep(0.5)
    assert not eng.done.is_set()
    assert len(stub.created) < 400
    assert depth() <= 64 + 256
    assert eng.backpressure_stalls >= 1
    drained[0] = 10000  # drain the "queue": the engine resumes
    assert eng.join(timeout=10.0)
    assert eng.created == 400
    assert eng.stall_seconds > 0.0


def test_engine_stop_interrupts_a_stall():
    stub = _StubClient()
    eng = ArrivalEngine(
        stub, np.zeros(300), lambda i: make_pod(f"c-{i}").obj(),
        depth_fn=lambda: 10_000, max_queue_depth=8,
    )
    eng.start()
    time.sleep(0.2)
    eng.stop()
    assert eng.created < 300


# -- the controller, both packages ------------------------------------------


def _walk(level_fn, n=200, interval=0.25, seed=9, drain=500, pop_wait=0.0):
    """(depth, cycle, t, pop_wait) tuples: Poisson depth around a level
    that may change with the step, a steady pop counter."""
    rng = np.random.default_rng(seed)
    series, cycle, pw = [], 0, 0.0
    for i in range(n):
        pw += pop_wait
        series.append((int(rng.poisson(level_fn(i))), cycle,
                       interval * (i + 1), pw))
        cycle += drain
    return series


def _overload(n=30, interval=0.25):
    """Sustained overload whose max-batch drains momentarily empty the
    visible queue every other interval (the pole-hunting shape)."""
    series, t, cycle = [], 0.0, 0
    for step in range(n):
        t += interval
        if step % 2 == 0:
            depth, cycle = 40000, cycle + 500
        else:
            depth, cycle = 50, cycle + 4000
        series.append((depth, cycle, t, 0.0))
    return series


def _backlog_then_idle():
    series = [(8000, 200 * (i + 1), 0.25 * (i + 1), 0.0) for i in range(40)]
    cycle = 200 * 40
    for i in range(60):
        cycle += 50
        series.append((0, cycle, 10.0 + 0.25 * (i + 1), 0.0))
    return series


SERIES = {
    "load_walk": (dict(slo_p99_seconds=1.0, max_batch=4096),
                  _walk(lambda i: 50 + 4000 * (60 <= i < 120))),
    "backlog_then_idle": (
        dict(slo_p99_seconds=1.0, latency_batch=256, max_batch=4096),
        _backlog_then_idle(),
    ),
    "saturated_no_drain": (
        dict(slo_p99_seconds=1.0, max_batch=2048),
        [(500, 0, 0.25 * (i + 1), 0.0) for i in range(10)],
    ),
    "half_slo_window": (
        dict(slo_p99_seconds=0.2, max_window=5.0, max_batch=4096),
        [(9000, 100 * (i + 1), 0.25 * (i + 1), 0.0) for i in range(50)],
    ),
    "idle_dispatcher": (
        dict(slo_p99_seconds=1.0, max_batch=4096),
        _walk(lambda i: 5000, n=20, drain=100, pop_wait=0.25),
    ),
    "steady_hold": (
        dict(slo_p99_seconds=1.0, max_batch=4096),
        _walk(lambda i: 300, n=100, seed=4, drain=250),
    ),
    "overload_latch": (
        dict(slo_p99_seconds=1.0, latency_batch=512, max_batch=4096),
        _overload(40),
    ),
    "unsmoothed_hunting": (
        dict(slo_p99_seconds=1.0, latency_batch=512, max_batch=4096,
             pressure_ewma_alpha=1.0, latch_after_steps=10 ** 9),
        _overload(),
    ),
    "latch_release": (
        dict(slo_p99_seconds=1.0, latency_batch=512, max_batch=4096),
        _overload(10) + [
            (10, 40000 + 1000 * (i + 1), 2.5 + 0.25 * (i + 1), 0.0)
            for i in range(20)
        ],
    ),
    "rung_ladder": (
        dict(slo_p99_seconds=1.0, latency_batch=512, max_batch=4096,
             rungs=[512, 1024, 2048, 4096], latch_after_steps=100),
        _backlog_then_idle(),
    ),
    "auto_rungs_drain": (
        dict(slo_p99_seconds=2.0, latency_batch=64, max_batch=1024,
             auto_rungs=True, interval_seconds=0.1),
        _walk(lambda i: 2000 * (i % 37 < 12), n=150, interval=0.1,
              drain=300, seed=13),
    ),
}


def _trajectory(controller, series):
    out = []
    for depth, cycle, t, pw in series:
        direction = controller.step(depth, cycle, t, pop_wait_seconds=pw)
        out.append((direction, controller.window, controller.batch_cap,
                    controller.latched, controller.pressure_ewma))
    return out


@pytest.mark.parametrize("name", sorted(SERIES))
def test_controller_trajectory_equals_the_jax_package(name):
    """Every decision, window, cap, latch state and smoothed pressure of
    the port's controller equals the JAX package's, step for step."""
    kw, series = SERIES[name]
    ours = AutoBatchController(**kw)
    theirs = JaxController(**kw)
    assert ours.rungs == theirs.rungs
    assert _trajectory(ours, series) == _trajectory(theirs, series)
    for attr in ("steps", "window_changes", "cap_changes", "grows",
                 "shrinks", "latches"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.steps == len(series)


def test_controller_grows_latches_and_shrinks_back():
    """The trajectories above are not trivial: backlog drives the
    controller to the throughput pole, idle brings it back, sustained
    overload latches it in at most two moves."""
    c = AutoBatchController(
        slo_p99_seconds=1.0, latency_batch=256, max_batch=4096
    )
    _trajectory(c, _backlog_then_idle()[:40])
    assert c.batch_cap == 4096 and c.window == c.max_window
    _trajectory(c, _backlog_then_idle()[40:])
    assert c.batch_cap == 256 and c.window == c.min_window
    o = AutoBatchController(
        slo_p99_seconds=1.0, latency_batch=512, max_batch=4096
    )
    _trajectory(o, _overload())
    assert o.latched and o.grows + o.shrinks <= 2


@pytest.mark.parametrize("costs,want", [
    ({512: 0.020, 1024: 0.040, 2048: 0.095, 4096: 0.100}, [512, 1024, 4096]),
    ({512: 0.02, 4096: 0.1}, [512, 4096]),
    ({512: 0.01, 1024: 0.045, 2048: 0.05, 4096: 0.1}, [512, 2048, 4096]),
])
def test_calibrate_equals_the_jax_package(costs, want):
    ours = AutoBatchController(
        latency_batch=512, max_batch=4096, auto_rungs=True
    )
    theirs = JaxController(latency_batch=512, max_batch=4096, auto_rungs=True)
    assert ours.rungs == theirs.rungs == [512, 1024, 2048, 4096]
    assert ours.calibrate(dict(costs)) == theirs.calibrate(dict(costs)) == want
    assert ours.batch_cap == theirs.batch_cap


def test_rounding_clamps_and_explicit_rungs():
    c = AutoBatchController(
        slo_p99_seconds=1.0, latency_batch=100, max_batch=4096
    )
    assert c.latency_batch == 64  # bucket-rounded down
    assert AutoBatchController(
        latency_batch=9999, max_batch=512
    ).latency_batch == 512
    assert AutoBatchController(
        latency_batch=256, max_batch=2048, rungs=[300, 1000, 9999]
    ).rungs == [256, 960, 2048]
    with pytest.raises(ValueError):
        AutoBatchController(slo_p99_seconds=0.0)


class _Sched:
    """What maybe_step reads and writes."""

    class _Queue:
        def __init__(self):
            self.depth = 0
            self.scheduling_cycle = 0

        def active_count(self):
            return self.depth

    def __init__(self):
        self.queue = self._Queue()
        self.stage_seconds = {"pop_wait": 0.0}
        self.batch_window = None
        self.dispatch_batch_cap = None


def test_maybe_step_is_time_gated_and_pushes_the_outputs():
    clock = {"t": 0.0}
    c = AutoBatchController(
        slo_p99_seconds=1.0, latency_batch=64, max_batch=1024,
        interval_seconds=0.25, now=lambda: clock["t"],
    )
    sched = _Sched()
    assert c.maybe_step(sched) == "hold"  # primes
    assert c.maybe_step(sched) is None  # inside the interval
    sched.queue.depth = 5000
    sched.queue.scheduling_cycle = 10
    for _ in range(3):
        clock["t"] += 0.25
        c.maybe_step(sched)
    assert c.grows >= 1
    assert sched.batch_window == c.window > 0
    assert sched.dispatch_batch_cap == c.batch_cap == 1024


# -- config wiring on the port ----------------------------------------------


def test_loader_parses_and_validates_the_streaming_block():
    cfg = load_config_from_dict({
        "streaming": {
            "enabled": True, "sloP99": "500ms", "maxWindow": "100ms",
            "latencyBatch": 128, "bandPriorityThreshold": 50,
            "maxQueueDepth": 5000, "trace": "bursty", "rate": 750,
            "seed": 9,
        }
    })
    st = cfg.streaming
    assert st.enabled and st.slo_p99_seconds == 0.5
    assert st.max_window_seconds == 0.1 and st.latency_batch == 128
    assert st.band_priority_threshold == 50 and st.max_queue_depth == 5000
    assert (st.trace, st.rate_pods_per_sec, st.seed) == ("bursty", 750.0, 9)
    assert validate_config(cfg) == []


@pytest.mark.parametrize("block,needle", [
    ({"trace": "lognormal"}, "streaming.trace"),
    ({"trace": "replay"}, "replayPath"),
    ({"sloP99": 0}, "sloP99"),
    ({"minWindow": 1.0, "maxWindow": 0.5}, "maxWindow"),
])
def test_validation_rejects_bad_streaming(block, needle):
    cfg = load_config_from_dict({"streaming": block})
    assert any(needle in e for e in validate_config(cfg))


def _from_config(raw):
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    cfg = load_config_from_dict(raw)
    return client, informers, new_scheduler_from_config(
        client, informers, cfg, device="cpu"
    )


def test_from_config_attaches_the_controller_and_bands():
    _, informers, sched = _from_config({
        "tpuSolver": {"maxBatch": 128},
        "streaming": {
            "enabled": True, "sloP99": 2.0, "latencyBatch": 64,
            "bandPriorityThreshold": 75,
        },
    })
    try:
        assert isinstance(sched, BatchScheduler)
        assert isinstance(sched.autobatch, AutoBatchController)
        assert sched.autobatch.slo == 2.0
        assert sched.autobatch.latency_batch == 64
        assert sched.autobatch.max_batch == 128
        assert sched.queue.band_threshold == 75
        # the controller's outputs are live on the scheduler
        assert sched.dispatch_batch_cap == sched.autobatch.batch_cap == 64
        assert sched.batch_window == sched.autobatch.window
    finally:
        sched.stop()
        informers.stop()


def test_band_threshold_arms_without_the_batch_solver():
    _, informers, sched = _from_config({
        "tpuSolver": {"enabled": False},
        "streaming": {"enabled": True, "bandPriorityThreshold": 40},
    })
    try:
        assert sched.queue.band_threshold == 40
        assert getattr(sched, "autobatch", None) is None
    finally:
        sched.stop()


def test_streaming_off_keeps_the_static_knobs():
    _, informers, sched = _from_config({
        "tpuSolver": {"maxBatch": 128, "batchWindow": 0.02},
    })
    try:
        assert sched.autobatch is None
        assert sched.dispatch_batch_cap is None
        assert sched.batch_window == 0.02
        assert sched.queue.band_threshold is None
    finally:
        sched.stop()
        informers.stop()


def test_auto_rungs_warmup_times_each_rung_and_calibrates():
    """With ``autoRungs`` the controller seeds a geometric ladder; warmup
    times one steady solve at each rung's size and hands the times to
    ``calibrate``, which keeps the poles."""
    client, informers, sched = _from_config({
        "tpuSolver": {"maxBatch": 1024},
        "streaming": {
            "enabled": True, "latencyBatch": 128, "autoRungs": True,
        },
    })
    try:
        assert sched.autobatch.rungs == [128, 256, 512, 1024]
        for i in range(8):
            client.create_node(
                make_node(f"n{i}").capacity(cpu="8", memory="16Gi").obj()
            )
        informers.start()
        informers.wait_for_cache_sync()
        sched.warmup()
        assert sorted(sched.rung_solve_seconds) == [128, 256, 512, 1024]
        assert all(s > 0 for s in sched.rung_solve_seconds.values())
        rungs = sched.autobatch.rungs
        assert rungs[0] == 128 and rungs[-1] == 1024
        assert set(rungs) <= {128, 256, 512, 1024}
    finally:
        sched.stop()
        informers.stop()


def test_cap_bounds_the_pop():
    """The controller's cap, not max_batch, bounds what one pop drains."""
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(
        client, informers, batch=True, max_batch=256, device="cpu"
    )
    sched.attach_autobatch(AutoBatchController(
        slo_p99_seconds=5.0, latency_batch=64, max_batch=256,
        interval_seconds=60.0,
    ))
    for i in range(4):
        client.create_node(
            make_node(f"n{i}").capacity(cpu="64", memory="64Gi", pods=200)
            .obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    try:
        sched.warmup()
        client.create_pods_bulk([
            make_pod(f"p-{i}").container(cpu="100m").obj()
            for i in range(150)
        ])
        deadline = time.time() + 10
        while sched.queue.active_count() < 150 and time.time() < deadline:
            time.sleep(0.01)
        sizes = []
        while sum(sizes) < 150 and time.time() < deadline:
            n = sched.schedule_batch(timeout=0.5)
            if n:
                sizes.append(n)
        assert sizes and max(sizes) == 64 and sum(sizes) == 150
    finally:
        sched.stop()
        informers.stop()


def test_controller_oscillation_guard_steady_poisson_e2e():
    """A steady seeded Poisson trace through the port's real stack on
    the CPU, with the controller attached, converges: few controller
    moves and no backpressure at a rate the stack sustains."""
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(
        client, informers, batch=True, max_batch=256, device="cpu"
    )
    controller = AutoBatchController(
        slo_p99_seconds=2.0, latency_batch=64, max_batch=256,
        interval_seconds=0.1,
    )
    sched.attach_autobatch(controller)
    for i in range(16):
        client.create_node(
            make_node(f"n{i}").capacity(cpu="64", memory="256Gi", pods=120)
            .obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()
    sched.start()
    try:
        n = 800
        offsets = poisson_trace(400.0, n / 400.0, seed=21)[:n]
        n = int(offsets.size)
        eng = ArrivalEngine(
            client, offsets,
            lambda i: make_pod(f"sp-{i}")
            .container(cpu="100m", memory="128Mi").obj(),
            depth_fn=sched.queue.active_count,
            max_queue_depth=10 * 256,
        )
        eng.start()
        assert eng.join(timeout=60.0)
        deadline = time.time() + 120
        while time.time() < deadline:
            bound = sum(1 for p in client.list_pods()[0] if p.spec.node_name)
            if bound >= n:
                break
            time.sleep(0.05)
        assert bound == n, f"only {bound}/{n} pods bound"
        sched.wait_for_inflight_binds()
        assert controller.steps >= 5
        assert controller.window_changes + controller.cap_changes <= 6
        assert eng.backpressure_stalls == 0
        assert set(eng.created_ts) == {f"sp-{i}" for i in range(n)}
    finally:
        sched.stop()
        informers.stop()
