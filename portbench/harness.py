"""One run of one cell of the port's benchmark.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run builds the configuration's cluster through the program's entry
points (``APIServer``, ``Client``, ``InformerFactory`` and
``new_scheduler(batch=True)`` on the card), binds the set-up pods, runs
one unmeasured pass of the cell's traffic, then measures for
``--seconds``. Closed traffic is one client's bursts: each burst is
created in bulk chunks, every bind is awaited, the burst's pods are
deleted (the job has finished) and the client fences until the
scheduler's cache holds none of them.

With ``--trace 0`` the last line carries the cell's end-to-end metrics;
with ``--trace 1`` the window runs under ``torch.profiler`` and the
flight recorder's trace, and the line carries the per-layer metrics.

Once the window has closed (and a grace of a minute for late binds),
every measured pod's node is compared with the plain NumPy reference
(``portbench/reference``), which works the cluster out from the
benchmark's own inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from portbench import spec as specmod
from portbench.reference.scheduler import FLOAT32, Arithmetic
from portbench.workload import (
    PodMaker, make_node, node_name, node_order, pod_spec, reference_setup,
)

#: top-level module names that may not be loaded once the window closes:
#: JAX and the JAX package this program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "kubernetes_tpu")
#: seconds a pod created in the window may take to bind after it closes
GRACE_S = 60.0
#: seconds set-up waits at its end for the dispatcher to go idle
IDLE_SETTLE_S = 1.5
CHECK_LIMITS = dict(misplaced=0, unbound=0, bound_twice=0, over_capacity=0)


class RunError(RuntimeError):
    """The run cannot produce a result."""


def process_start() -> Optional[float]:
    """``time.perf_counter`` at this process's start (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except OSError:
        return None
    age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - age


_T_START = process_start() or time.perf_counter()


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


class BindWatch:
    """Each pod's first bind (time, node) from the apiserver's watch, and
    the pods later seen on another node."""

    def __init__(self, server):
        self._watch = server.watch("Pod", since_rv=server.current_rv())
        self.bound: Dict[str, Tuple[float, str]] = {}
        self.rebound: set = set()
        self._cond = threading.Condition()
        self._targets: set = set()
        self._outstanding = 0
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="portbench-watch", daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            evs = self._watch.next_batch(timeout=0.2)
            if not evs:
                continue
            now = time.perf_counter()
            with self._cond:
                for ev in evs:
                    pod = ev.object
                    node = pod.spec.node_name
                    if ev.type != "MODIFIED" or not node:
                        continue
                    name = pod.metadata.name
                    prev = self.bound.get(name)
                    if prev is None:
                        self.bound[name] = (now, node)
                        if name in self._targets:
                            self._outstanding -= 1
                    elif prev[1] != node:
                        self.rebound.add(name)
                if self._outstanding <= 0:
                    self._cond.notify_all()

    def expect(self, names) -> None:
        """Await these pods from now on."""
        with self._cond:
            self._targets = set(names)
            self._outstanding = sum(1 for n in self._targets
                                    if n not in self.bound)

    def add_expected(self, names) -> None:
        with self._cond:
            for n in names:
                if n not in self._targets:
                    self._targets.add(n)
                    if n not in self.bound:
                        self._outstanding += 1

    def wait(self, deadline: float) -> bool:
        """Until every awaited pod is bound or ``deadline`` (perf s)."""
        with self._cond:
            while self._outstanding > 0:
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.05))
            return True

    def stop(self) -> None:
        self._stop = True
        self._watch.stop()
        self._thread.join(timeout=5)


#: the operands of each K2 family that ``roofline.k2_launch`` reads:
#: spread whole; affinity's incoming, anti and existing-pod rows;
#: scoring's selector group, soft-spread groups and affinity node values
K2_READ = (frozenset(range(7)), frozenset((3, 8, 12)),
           frozenset((7, 11, 13)))


class LaunchCapture:
    """In a traced window: a copy of each K1 and K2 launch's operands and
    answer, taken on the launch's stream right after it, so that the
    roofline readers can count the operations each launch needed."""

    def __init__(self):
        from kubernetes_tpu_torch.ops import constrained_kernel, greedy_kernel

        self._gk, self._ck = greedy_kernel, constrained_kernel
        self.k1: List[tuple] = []
        self.k2: List[tuple] = []

    @staticmethod
    def _copy(t):
        return t.detach().clone()

    def __enter__(self):
        gk, ck = self._gk, self._ck
        self._orig = (gk.greedy_solve_cuda, ck.constrained_solve_cuda)
        orig_k1, orig_k2 = self._orig

        def k1(*args, **kwargs):
            out = orig_k1(*args, **kwargs)
            if kwargs.get("prior") is None and len(args) >= 9:
                cfg = kwargs.get("config")
                self.k1.append((
                    [self._copy(a) for a in args[:9]], self._copy(out[0]),
                    _weights(cfg),
                ))
            return out

        def k2(*args, **kwargs):
            out = orig_k2(*args, **kwargs)
            if len(args) >= 12:
                # the count reads the spread family whole and a few rows of
                # the others; the rest only for their bytes
                fams = tuple(
                    tuple(self._copy(a) if k in keep else None
                          for k, a in enumerate(f))
                    for f, keep in zip(args[9:12], K2_READ))
                n_bytes = sum(t.element_size() * t.numel() for f in args[9:12]
                              for t in f)
                self.k2.append((
                    [self._copy(a) for a in args[:9]], fams,
                    self._copy(out[0]), _weights(kwargs.get("config")),
                    n_bytes,
                ))
            return out

        gk.greedy_solve_cuda, ck.constrained_solve_cuda = k1, k2
        return self

    def __exit__(self, *exc):
        self._gk.greedy_solve_cuda, self._ck.constrained_solve_cuda = self._orig
        return False

    def records(self):
        """Per launch, in order: the roofline counts (host numpy)."""
        from portbench.roofline import k1_launch, k2_launch

        def host(ts):
            return [t.cpu().numpy() for t in ts]

        k1 = []
        for ops, out, w in self.k1:
            (alloc, requested, _, valid, pod_requests, _, mask_rows,
             mask_index, active) = host(ops)
            k1.append(k1_launch(alloc, requested, valid, pod_requests,
                                mask_rows, mask_index, active,
                                out.cpu().numpy(), weights=w))
        k2 = [k2_launch(host(ops),
                        *([None if t is None else t.cpu().numpy() for t in f]
                          for f in fams),
                        out.cpu().numpy(), weights=w, family_bytes=n_bytes)
              for ops, fams, out, w, n_bytes in self.k2]
        return k1, k2


def _weights(cfg) -> Tuple[int, int, int]:
    if cfg is None:
        return (1, 1, 0)
    return (int(cfg.least_allocated_weight),
            int(cfg.balanced_allocation_weight),
            int(cfg.most_allocated_weight))


@dataclass
class Burst:
    names: List[str]
    t_start: float = 0.0
    t_bound: Optional[float] = None


@dataclass
class Run:
    """Everything a metric reader may read of one run."""

    cell: Any
    seed: int
    seconds: float
    trace: bool
    config: Dict[str, Any] = field(default_factory=dict)
    traffic: Dict[str, Any] = field(default_factory=dict)
    #: node indices in creation (row) order
    node_order: List[int] = field(default_factory=list)
    warm_names: List[str] = field(default_factory=list)
    warm_bound: Dict[str, Optional[str]] = field(default_factory=dict)
    device_name: str = ""
    memory_peak_bytes: int = 0
    setup_s: float = 0.0
    setup_items: Dict[str, float] = field(default_factory=dict)
    t0: float = 0.0
    t1: float = 0.0
    #: measured pods in creation order, and each one's create time
    order: List[str] = field(default_factory=list)
    created: Dict[str, float] = field(default_factory=dict)
    bound: Dict[str, Tuple[float, str]] = field(default_factory=dict)
    bursts: List[Burst] = field(default_factory=list)
    fences: List[Tuple[float, float]] = field(default_factory=list)
    stages0: Dict[str, float] = field(default_factory=dict)
    stages1: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    device: Any = None  # devtrace.DeviceWindow in a traced run
    #: when the launch capture began (perf_counter s)
    capture_t0: float = 0.0
    host_spans: List[dict] = field(default_factory=list)
    k1_records: List[dict] = field(default_factory=list)
    k2_records: List[dict] = field(default_factory=list)
    rebound: set = field(default_factory=set)
    #: (name, node) of every pod the apiserver holds at the end
    final_pods: List[Tuple[str, Optional[str]]] = field(default_factory=list)
    notes: Dict[str, Any] = field(default_factory=dict)

    def bound_in_window(self) -> int:
        return sum(1 for n in self.order
                   if n in self.bound and self.t0 <= self.bound[n][0] <= self.t1)

    def stage_delta(self, stage: str) -> float:
        return self.stages1.get(stage, 0.0) - self.stages0.get(stage, 0.0)


# -- the run -------------------------------------------------------------

def _scaled(cell, scale: Optional[dict]):
    """The cell's configuration and traffic, with ``scale``'s overrides
    (the CPU tests' tiny sizes) applied."""
    config = json.loads(json.dumps(cell.config))
    traffic = dict(cell.traffic)
    for key, value in (scale or {}).items():
        part, _, name = key.partition(".")
        if part == "traffic":
            traffic[name] = value
        else:
            config[part][name] = value
    return config, traffic


class _Stack:
    """The program under test, built as an operator would run it."""

    def __init__(self, config, seed: int, device: str):
        import random

        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.client.client import Client
        from kubernetes_tpu_torch.client.informer import InformerFactory
        from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler

        settings = config["scheduler"]
        self.server = APIServer()
        self.client = Client(self.server)
        self.informers = InformerFactory(self.server)
        self.sched = new_scheduler(
            self.client, self.informers, batch=bool(settings["batch"]),
            max_batch=int(settings["max_batch"]), device=device,
            rng=random.Random(seed),
        )
        if self.sched.device.type != device:
            raise RunError(f"the scheduler solves on {self.sched.device}")

    def stop(self):
        self.sched.stop()
        self.informers.stop()


def _create(stack, maker, names) -> Tuple[float, List[str]]:
    """Create ``names`` in one bulk call; returns (time of the call, uids)."""
    pods = [maker(n) for n in names]
    t = time.perf_counter()
    stack.client.create_pods_bulk(pods)
    return t, [p.metadata.uid for p in pods]


def _fence(stack, uids: List[str], deadline: float) -> None:
    """Until the scheduler's cache holds none of ``uids``; reads only."""
    cache = stack.sched.cache
    i = 0
    while i < len(uids):
        if cache.has_pod_uid(uids[i]):
            if time.perf_counter() > deadline:
                raise RunError("the scheduler's cache kept deleted pods")
            time.sleep(0.0005)
        else:
            i += 1
    if any(cache.has_pod_uid(u) for u in uids):
        raise RunError("a deleted pod came back into the scheduler's cache")


def _closed_burst(stack, watch, template, traffic, names, stop_at=None):
    """Create one closed-loop burst in chunks, each chunk's pods awaited
    from its create. Stops creating at ``stop_at``. Returns (create time
    by name, uids)."""
    chunk = int(traffic["chunk"])
    created: Dict[str, float] = {}
    uids: List[str] = []
    watch.expect([])
    for lo in range(0, len(names), chunk):
        if stop_at is not None and time.perf_counter() >= stop_at:
            break
        part = names[lo:lo + chunk]
        watch.add_expected(part)
        t, ids = _create(stack, template, part)
        uids.extend(ids)
        for n in part:
            created[n] = t
    return created, uids


def _delete_and_fence(stack, names, uids, chunk, fences=None):
    t = time.perf_counter()
    for lo in range(0, len(names), chunk):
        stack.client.delete_pods_bulk(
            [("default", n) for n in names[lo:lo + chunk]])
    _fence(stack, uids, t + 120.0)
    if fences is not None:
        fences.append((t, time.perf_counter()))


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", scale: Optional[dict] = None) -> Run:
    """Set up, warm up and measure one cell; the reference check and the
    metrics come after (``finish``)."""
    import torch

    config, traffic = _scaled(cell, scale)
    if traffic.get("kind") != "closed":
        raise specmod.SpecError(
            f"traffic {cell.traffic_name!r}: only closed bursts are run")
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              config=config, traffic=traffic)
    items = run.setup_items
    t = time.perf_counter()
    items["process_to_harness_s"] = t - _T_START
    if device == "cuda":
        torch.cuda.init()
        torch.empty(1, device="cuda")
        run.device_name = torch.cuda.get_device_name(0)
        torch.cuda.reset_peak_memory_stats()
    else:
        run.device_name = "cpu"
    items["cuda_context_s"] = time.perf_counter() - t

    t = time.perf_counter()
    order = node_order(config, seed)
    run.node_order = order
    stack = _Stack(config, seed, device)
    items["import_and_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for i in order:
        stack.client.create_node(make_node(config, i))
    stack.informers.start()
    stack.informers.wait_for_cache_sync()
    stack.sched.queue.run()
    items["nodes_and_sync_s"] = time.perf_counter() - t
    t = time.perf_counter()
    stack.sched.warmup()
    items["warmup_s"] = time.perf_counter() - t

    watch = BindWatch(stack.server)
    try:
        t = time.perf_counter()
        setup_maker = PodMaker(config["setup_pods"])
        setup_names = [f"s-{i}" for i in range(int(config["setup_pods"]["count"]))]
        watch.expect(setup_names)
        for lo in range(0, len(setup_names), 256):
            _create(stack, setup_maker, setup_names[lo:lo + 256])
        stack.sched.start()
        if not watch.wait(time.perf_counter() + 600):
            raise RunError("the set-up pods did not all bind")
        stack.sched.wait_for_inflight_binds(timeout=60)
        items["setup_pods_s"] = time.perf_counter() - t

        from kubernetes_tpu_torch.utils.gc_tuning import (
            freeze_steady_state_graph,
        )

        template = PodMaker(config["pod"])
        chunk = int(traffic["chunk"])
        # one unmeasured pass of this cell's shapes: a burst of the
        # cell's size, deleted again
        t = time.perf_counter()
        warm_names = [f"w-{i}" for i in range(int(traffic["burst"]))]
        _, warm_uids = _closed_burst(stack, watch, template, traffic,
                                     warm_names)
        if not watch.wait(time.perf_counter() + 600):
            raise RunError("the warm-up burst did not all bind")
        stack.sched.wait_for_inflight_binds(timeout=60)
        run.warm_names = warm_names
        run.warm_bound = {n: watch.bound.get(n, (0, None))[1]
                          for n in warm_names}
        _delete_and_fence(stack, warm_names, warm_uids, chunk)
        items["warm_burst_s"] = time.perf_counter() - t

        # let the dispatcher's empty pop (0.5 s) take it idle, so its idle
        # collect runs here and its in-flight collect timer (every 10 s
        # under load) starts with the window's first batch in every run
        time.sleep(IDLE_SETTLE_S)
        freeze_steady_state_graph()
        if device == "cuda":
            torch.cuda.synchronize()

        _measure(run, stack, watch, template, traffic)
        run.bound = dict(watch.bound)
        run.rebound = set(watch.rebound)
        if device == "cuda":
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        pods, _ = stack.client.list_pods()
        run.final_pods = [(p.metadata.name, p.spec.node_name) for p in pods]
    finally:
        watch.stop()
        stack.stop()
    return run


def _measure(run, stack, watch, template, traffic):
    """The measured window, then the grace for late binds."""
    from kubernetes_tpu_torch.ops import constrained_kernel, greedy_kernel
    from kubernetes_tpu_torch.utils import flightrecorder

    sched = stack.sched
    tracer = capture = None
    if run.trace:
        flightrecorder.start_trace()
        if run.device_name != "cpu":
            from portbench.devtrace import DeviceTrace

            # every captured launch is made while the profiler records
            tracer = DeviceTrace()
            tracer.start()
            capture = LaunchCapture().__enter__()
            run.capture_t0 = time.perf_counter()
    k1_0, k2_0 = greedy_kernel.launches, constrained_kernel.launches
    run.stages0 = dict(sched.stage_seconds)
    run.t0 = t0 = time.perf_counter()
    run.setup_s = t0 - _T_START
    t1 = t0 + run.seconds
    try:
        _closed_window(run, stack, watch, template, traffic, t1)
    finally:
        if tracer is not None:
            capture.__exit__(None, None, None)
            run.device = tracer.stop()
        run.t1 = t1
        run.stages1 = dict(sched.stage_seconds)
        run.launches = dict(k1=greedy_kernel.launches - k1_0,
                            k2=constrained_kernel.launches - k2_0)
    if run.trace:
        run.host_spans = [e for e in flightrecorder.stop_trace()
                          if e.get("ph") == "X"]
    watch.expect([n for n in run.order if n not in watch.bound])
    watch.wait(time.perf_counter() + GRACE_S)
    sched.wait_for_inflight_binds(timeout=30)
    if capture is not None:
        run.k1_records, run.k2_records = capture.records()


def _closed_window(run, stack, watch, template, traffic, t1):
    size = int(traffic["burst"])
    chunk = int(traffic["chunk"])
    k = 0
    while time.perf_counter() < t1:
        names = [f"m{k}-{i}" for i in range(size)]
        burst = Burst(names, t_start=time.perf_counter())
        created, uids = _closed_burst(stack, watch, template, traffic, names,
                                      stop_at=t1)
        burst.names = [n for n in names if n in created]
        run.bursts.append(burst)
        run.order.extend(burst.names)
        run.created.update(created)
        if not watch.wait(t1) or len(burst.names) < size:
            break
        burst.t_bound = max(watch.bound[n][0] for n in burst.names)
        if time.perf_counter() >= t1:
            break
        _delete_and_fence(stack, burst.names, uids, chunk, run.fences)
        k += 1


# -- the check -----------------------------------------------------------

def expected_nodes(run, arithmetic: Arithmetic = FLOAT32) -> Dict[str, str]:
    """The reference's node for every measured pod of ``run``."""
    config, order = run.config, run.node_order
    cluster = reference_setup(config, order, arithmetic)
    spec = pod_spec(config["pod"])
    names = [node_name(i) for i in order]
    out: Dict[str, str] = {}
    # every burst starts from the set-up's state: its pods are deleted
    # before the next burst's first create
    rows = cluster.place_all([spec] * int(run.traffic["burst"]))
    for b in run.bursts:
        for i, n in enumerate(b.names):
            out[n] = names[rows[i]] if rows[i] >= 0 else None
    return out


def judge(run, placed: Dict[str, Optional[str]],
          expected: Dict[str, Optional[str]]) -> Dict[str, int]:
    """The compared numbers, each held to CHECK_LIMITS."""
    measured = run.order
    misplaced = sum(1 for n in measured
                    if placed.get(n) is not None and placed[n] != expected[n])
    unbound = sum(1 for n in measured if placed.get(n) is None)
    bound_twice = sum(1 for n in measured if n in run.rebound)
    over = _over_capacity(run)
    over_pods = sum(1 for n in measured if placed.get(n) in over)
    return dict(misplaced=misplaced, unbound=unbound,
                bound_twice=bound_twice, over_capacity=over_pods)


def _over_capacity(run) -> set:
    """Nodes whose live pods at the end ask for more than they hold."""
    from portbench.workload import parse_bytes, parse_milli_cpu

    cfg = run.config
    cap = (parse_milli_cpu(cfg["nodes"]["cpu"]),
           parse_bytes(cfg["nodes"]["memory"]), int(cfg["nodes"]["pods"]))
    shapes = {"s": cfg["setup_pods"], "w": cfg["pod"], "m": cfg["pod"]}
    use: Dict[str, List[int]] = {}
    for name, node in run.final_pods:
        if not node:
            continue
        tpl = shapes[name[0]]
        u = use.setdefault(node, [0, 0, 0])
        u[0] += parse_milli_cpu(tpl["cpu"])
        u[1] += parse_bytes(tpl["memory"])
        u[2] += 1
    return {n for n, u in use.items() if any(a > c for a, c in zip(u, cap))}


def finish(run, arithmetic: Arithmetic = FLOAT32) -> Dict[str, Any]:
    """The reference check and the metrics: the result line's object."""
    t = time.perf_counter()
    placed = {n: run.bound[n][1] for n in run.order if n in run.bound}
    expected = expected_nodes(run, arithmetic)
    checks = judge(run, placed, expected)
    reference_s = time.perf_counter() - t
    warm_expected = expected_nodes_warm(run, arithmetic)
    warm_misplaced = sum(1 for n, node in run.warm_bound.items()
                         if node != warm_expected.get(n))
    metrics = {}
    for m in (run.cell.per_layer if run.trace else run.cell.end_to_end):
        value = specmod.load_reader(m.name, run.cell.root)(run)
        if value is None:
            continue
        metrics[m.name] = {"value": float(value), "unit": m.unit}
    failed = checks["unbound"] + checks["bound_twice"] + checks["over_capacity"]
    correct = all(checks[k] <= CHECK_LIMITS[k] for k in CHECK_LIMITS)
    result = {
        "correct": bool(correct),
        "attempted": len(run.order),
        "failed": int(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if run.device_name != "cpu" else "cpu",
            "kind": run.device_name,
            "count": run.cell.chips,
            "memory_peak_bytes": run.memory_peak_bytes,
        },
    }
    if run.trace and run.device is not None:
        result["device"]["busy_s"] = run.device.busy_s()
        result["device"]["window_s"] = run.device.window_s
        result["breakdown"] = breakdown(run)
    result["checks"] = {k: {"value": v, "limit": CHECK_LIMITS[k]}
                        for k, v in checks.items()}
    run.notes.update(reference_s=reference_s,
                     warm_misplaced=warm_misplaced)
    return result


def expected_nodes_warm(run, arithmetic: Arithmetic = FLOAT32):
    cluster = reference_setup(run.config, run.node_order, arithmetic)
    spec = pod_spec(run.config["pod"])
    rows = cluster.place_all([spec] * len(run.warm_names))
    names = [node_name(i) for i in run.node_order]
    return {n: names[r] if r >= 0 else None
            for n, r in zip(run.warm_names, rows)}


def breakdown(run) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps, each named after the host stage span that covers most of it."""
    dev = run.device
    ops = sorted(dev.seconds_by_name().items(), key=lambda kv: -kv[1])[:10]
    spans = [(e["name"], e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6)
             for e in run.host_spans]
    spans += [("client fence", s, e) for s, e in run.fences]
    gaps = sorted(dev.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        best, label = 0.0, "no host span"
        for name, hs, he in spans:
            overlap = min(e, he) - max(s, hs)
            if overlap > best:
                best, label = overlap, name
        named.append([f"{label} at +{s - run.t0:.3f}s", e - s])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


# -- the command ---------------------------------------------------------

def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _say(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    cell = specmod.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _say(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " visible")
        return 3
    root = specmod.ROOT
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(root, "build", "torch_extensions"))
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    result = finish(run)
    loaded = forbidden_loaded()
    if loaded:
        _say(f"portbench: forbidden modules loaded: {', '.join(loaded)}")
        return 4
    _say("setup " + json.dumps({k: round(v, 4)
                                for k, v in run.setup_items.items()}))
    done = [b for b in run.bursts if b.t_bound is not None]
    if done:
        _say("bursts s: " + " ".join(
            f"{b.t_bound - b.t_start:.3f}" for b in done))
        _say("fences ms: " + " ".join(
            f"{(e - s) * 1e3:.1f}" for s, e in run.fences))
    _say(f"reference {run.notes['reference_s']:.3f} s; warm-up burst "
         f"misplaced {run.notes['warm_misplaced']}")
    for k, v in result["checks"].items():
        _say(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0
