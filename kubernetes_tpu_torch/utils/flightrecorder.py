"""Always-on flight recorder: the last K batch spans + control-plane
marks, dumpable as JSON when something goes wrong.

Twelve PRs of robustness machinery (ladders, breakers, waves,
partitions) degrade observably only as scattered counters; this module
is the single record that reconstructs *what happened to batch N*:

- ``BatchSpan``: one monotonically-numbered record per dispatch --
  batch size, pad shape, solver tier actually run, carry decision
  (reuse / delta scatter / full upload), per-stage wall clock, commit
  outcome, conflicts absorbed, per-pod linkage (uid -> batch id,
  queue-wait, attempt count).
- marks: breaker transitions, ladder fallbacks, fault points fired,
  fencing aborts, partition takeovers, preemption waves, mid-run jit
  recompiles, arrival-engine stalls, autobatch decisions.

The ring is bounded (``deque(maxlen=...)``) and lock-cheap: one short
lock hold per span begin / mark; span field updates are owned by the
single thread driving that batch (dispatcher, then committer -- the
pipeline hands the batch off, never shares it). ``KTPU_FLIGHTRECORDER=0``
compiles the spine out (begin_batch returns the no-op NullSpan, mark
returns immediately) -- the arm the overhead microbench compares
against.

Dump triggers: ``/debug/flightrecorder`` (scheduler/app.py), SIGUSR1,
and ``dump_on_degraded`` wherever a component raises the
degraded-health gauge. Chaos e2es assert against ``RECORDER.dump()``
instead of grepping logs.

The module doubles as the Chrome-trace event sink: ``start_trace()``
arms a buffer and every span stage / instant mark also lands there as a
Chrome-trace event; ``export_chrome_trace`` writes JSON that loads in
ui.perfetto.dev. Zero cost when not armed (one None check). Besides the
stages, an armed buffer takes child spans of a stage (``substep``), the
collector's pauses (``gc_pause``, fed by ``utils/gc_tuning``), counter
tracks (``trace_counter``), and the card's own time per kernel launch
(``launch_begin``/``launch_end`` at the launch site, ``device_spans``
once the launch's result is on the host) on the ``device`` track, put
on the host's ``perf_counter`` clock through an anchor event that
``start_trace`` records. ``clock_sync`` metadata events at the start and
the stop pair ``perf_counter`` with the wall clock that
``torch.profiler`` stamps.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: compile-out switch: the spine costs ~1us per op when on; off, the
#: begin/mark calls return immediately (the microbench's OFF arm)
ENABLED = os.environ.get("KTPU_FLIGHTRECORDER", "1") != "0"
SPAN_CAPACITY = int(os.environ.get("KTPU_FLIGHTRECORDER_SPANS", "512"))
MARK_CAPACITY = int(os.environ.get("KTPU_FLIGHTRECORDER_MARKS", "4096"))
#: where degraded-health / SIGUSR1 dumps land
DUMP_DIR = os.environ.get("KTPU_FLIGHTRECORDER_DIR", ".")


class BatchSpan:
    """One dispatch's record. Mutated only by the thread currently
    driving the batch (dispatcher -> committer hand-off; the async bulk
    bind bumps ``conflicts`` last). Lives in the ring from begin, so a
    dump mid-flight shows the batch in its current state."""

    __slots__ = (
        "batch_id", "t_start", "t_end", "size", "padded", "tier",
        "carry", "delta_rows", "stages", "placed", "no_node",
        "gang_masked", "spilled", "volume_retries", "conflicts",
        "routed", "pods", "thread", "extra",
    )

    def __init__(self, batch_id: int, size: int, pods) -> None:
        self.batch_id = batch_id
        self.t_start = time.perf_counter()
        self.t_end: Optional[float] = None
        self.size = size
        self.padded: Optional[int] = None
        self.tier: Optional[str] = None
        self.carry: Optional[str] = None
        self.delta_rows = 0
        self.stages: Dict[str, float] = {}
        self.placed = 0
        self.no_node = 0
        self.gang_masked = 0
        self.spilled = 0
        self.volume_retries = 0
        self.conflicts = 0
        self.routed: Optional[str] = None  # non-device disposition
        #: (pod uid, queue-wait seconds, attempt count) per pod
        self.pods: List[Tuple[str, float, int]] = pods
        self.thread = threading.current_thread().name
        self.extra: Optional[dict] = None

    def stage(self, name: str, seconds: float,
              t0: Optional[float] = None,
              args: Optional[dict] = None) -> None:
        """Accumulate one stage's wall clock; when the Chrome-trace
        buffer is armed the stage also lands there as a duration event
        on the calling thread's track (t0 = perf_counter at start), with
        ``args`` beside the batch id."""
        self.stages[name] = self.stages.get(name, 0.0) + seconds
        if _trace is not None and t0 is not None:
            trace_span(name, t0, seconds,
                       args={"batch": self.batch_id, **(args or {})})

    def note(self, **fields) -> None:
        for k, v in fields.items():
            if k in BatchSpan.__slots__:
                setattr(self, k, v)
            else:
                if self.extra is None:
                    self.extra = {}
                self.extra[k] = v

    def bump(self, field: str, n: int = 1) -> None:
        setattr(self, field, getattr(self, field) + n)

    def finish(self, tier: Optional[str] = None,
               routed: Optional[str] = None) -> None:
        if tier is not None:
            self.tier = tier
        if routed is not None:
            self.routed = routed
        self.t_end = time.perf_counter()

    def __bool__(self) -> bool:
        return True

    def to_dict(self) -> dict:
        # copy the mutable members first: a dump can run concurrently
        # with the owning thread still stamping stages (mid-flight
        # batch on the debug endpoint / SIGUSR1 path) -- iterating the
        # live dicts would raise "changed size during iteration"
        stages = dict(self.stages)
        pods = list(self.pods)
        extra = dict(self.extra) if self.extra else None
        d = {
            "batch_id": self.batch_id,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "duration_ms": (
                round((self.t_end - self.t_start) * 1000.0, 3)
                if self.t_end is not None else None
            ),
            "size": self.size,
            "padded": self.padded,
            "tier": self.tier,
            "carry": self.carry,
            "delta_rows": self.delta_rows,
            "stages_ms": {
                k: round(v * 1000.0, 3) for k, v in stages.items()
            },
            "placed": self.placed,
            "no_node": self.no_node,
            "gang_masked": self.gang_masked,
            "spilled": self.spilled,
            "volume_retries": self.volume_retries,
            "conflicts": self.conflicts,
            "routed": self.routed,
            "thread": self.thread,
            "pods": [
                {"uid": uid, "queue_wait_ms": round(w * 1000.0, 3),
                 "attempts": att}
                for uid, w, att in pods
            ],
        }
        if extra:
            d["extra"] = extra
        return d


class _NullSpan:
    """The compiled-out span: every spine call is a no-op attribute
    access. Falsy so callers can branch on it cheaply."""

    __slots__ = ()

    def stage(self, name, seconds, t0=None, args=None):
        pass

    def note(self, **fields):
        pass

    def bump(self, field, n=1):
        pass

    def finish(self, tier=None, routed=None):
        pass

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class FlightRecorder:
    """The bounded ring of spans + marks. One process-global instance
    (``RECORDER``); chaos harnesses may construct private ones."""

    def __init__(self, span_capacity: int = SPAN_CAPACITY,
                 mark_capacity: int = MARK_CAPACITY) -> None:
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=span_capacity)
        self._marks: deque = deque(maxlen=mark_capacity)
        self._next_id = 0

    def begin_batch(self, size: int, pods=()) -> BatchSpan:
        """Allocate the next batch id and enter the span into the ring
        immediately (a mid-flight dump must show in-flight batches)."""
        with self._lock:
            self._next_id += 1
            span = BatchSpan(self._next_id, size, list(pods))
            self._spans.append(span)
        return span

    def mark(self, kind: str, /, **fields) -> None:
        """One timestamped control-plane event (breaker transition,
        fallback, fault fired, fencing abort, takeover, recompile...).
        ``kind`` is positional-only so a field may also be named
        ``kind``; the event kind wins in the dump."""
        self._marks.append((time.perf_counter(), kind, fields))

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._marks.clear()
            self._next_id = 0

    # -- dumps ---------------------------------------------------------

    def dump(self) -> dict:
        """Snapshot the rings as plain data (JSON-serializable)."""
        with self._lock:
            spans = list(self._spans)
            marks = list(self._marks)
        return {
            "dumped_at": time.time(),
            "perf_counter": time.perf_counter(),
            "next_batch_id": self._next_id,
            "spans": [s.to_dict() for s in spans],
            "marks": [
                # event kind last: it wins over a field named "kind"
                {**fields, "t": t, "kind": kind}
                for t, kind, fields in marks
            ],
        }

    def dump_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.dump(), indent=indent, default=str)

    def dump_to_file(self, reason: str) -> str:
        """Write the dump next to the process (KTPU_FLIGHTRECORDER_DIR)
        and return the path; failures log, never raise (the recorder
        must not take down the path that tripped it)."""
        path = os.path.join(
            DUMP_DIR,
            f"flightrecorder-{int(time.time())}-{reason}.json",
        )
        try:
            with open(path, "w") as f:
                f.write(self.dump_json(indent=1))
            logger.warning("flight recorder dumped to %s (%s)", path, reason)
        except Exception:  # noqa: BLE001 - never take down the caller
            logger.exception("flight recorder dump to %s failed", path)
        return path


RECORDER = FlightRecorder()


def begin_batch(size: int, pods=()) -> BatchSpan:
    if not ENABLED:
        return NULL_SPAN  # type: ignore[return-value]
    return RECORDER.begin_batch(size, pods)


def mark(kind: str, /, **fields) -> None:
    if not ENABLED:
        return
    RECORDER.mark(kind, **fields)


def dump_on_degraded(reason: str) -> Optional[str]:
    """Called wherever a component sets the degraded-health gauge: the
    moment something goes degraded is exactly when the last-K record is
    worth keeping."""
    if not ENABLED:
        return None
    RECORDER.mark("degraded", reason=reason)
    return RECORDER.dump_to_file(reason)


# -- Chrome-trace event buffer -------------------------------------------

_trace: Optional[list] = None
_trace_lock = threading.Lock()
_trace_tids: Dict[str, int] = {}
#: collections seen while armed: (thread name, start, seconds,
#: generation, collected). A gc callback appends here without a lock,
#: since a collection can start inside any allocation, also one made
#: under ``_trace_lock``; ``stop_trace`` turns them into spans
_gc_spans: List[tuple] = []
#: (device index, CUDA event, perf_counter s): the clock anchor that
#: ``start_trace`` records when the card is in use
_anchor: Optional[tuple] = None
#: per thread: the list a dispatch collects its kernel launches into
_launch_local = threading.local()


def _clock_sync(at: str) -> dict:
    """A metadata event pairing ``perf_counter`` (the spans' clock) with
    the wall clock (``torch.profiler``'s), so a joiner reads the offset
    at the start and its drift at the stop."""
    return {
        "ph": "M", "name": "clock_sync", "pid": 1, "tid": 0,
        "args": {"at": at, "perf_counter_ns": time.perf_counter_ns(),
                 "time_ns": time.time_ns()},
    }


#: tries at the clock anchor; the one whose enqueue the host clock
#: brackets most tightly is kept
ANCHOR_TRIES = 16


def _device_anchor() -> Optional[tuple]:
    """When torch is loaded and CUDA initialised: a timing event recorded
    on the idle current stream, with the perf_counter read right after
    it was enqueued (synchronizes here, never on the hot path). The
    record lets go of the interpreter, and another thread holding it can
    delay the read by milliseconds, so of several tries the one read
    soonest after its record is kept."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    best = None
    for _ in range(ANCHOR_TRIES):
        torch.cuda.synchronize()
        event = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        event.record()
        h1 = time.perf_counter()
        if best is None or h1 - h0 < best[0]:
            best = (h1 - h0, event, h1)
    torch.cuda.synchronize()
    return torch.cuda.current_device(), best[1], best[2]


def start_trace() -> None:
    """Arm the Chrome-trace buffer: from here every span stage, child
    span, collection, device launch, arrival stall and autobatch
    decision lands as a trace event."""
    global _trace, _anchor
    anchor = _device_anchor()
    with _trace_lock:
        _trace = [_clock_sync("start")]
        _trace_tids.clear()
        _gc_spans.clear()
        _anchor = anchor


def trace_active() -> bool:
    return _trace is not None


def _tid_for(name: str) -> int:
    """Stable small-int tid per track name, with a Perfetto thread_name
    metadata event emitted on first sight."""
    tid = _trace_tids.get(name)
    if tid is None:
        tid = len(_trace_tids) + 1
        _trace_tids[name] = tid
        _trace.append({  # type: ignore[union-attr]
            "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
            "args": {"name": name},
        })
    return tid


def trace_span(name: str, t0: float, dur: float,
               track: Optional[str] = None, args: Optional[dict] = None
               ) -> None:
    """One complete ('X') duration event; t0/dur in perf_counter
    seconds, converted to the trace's microsecond clock."""
    buf = _trace
    if buf is None:
        return
    with _trace_lock:
        if _trace is None:
            return
        ev = {
            "ph": "X", "name": name, "pid": 1,
            "tid": _tid_for(track or threading.current_thread().name),
            "ts": t0 * 1e6, "dur": max(dur, 0.0) * 1e6,
        }
        if args:
            ev["args"] = args
        _trace.append(ev)


def trace_instant(name: str, args: Optional[dict] = None,
                  track: Optional[str] = None) -> None:
    buf = _trace
    if buf is None:
        return
    with _trace_lock:
        if _trace is None:
            return
        ev = {
            "ph": "i", "name": name, "pid": 1, "s": "t",
            "tid": _tid_for(track or threading.current_thread().name),
            "ts": time.perf_counter() * 1e6,
        }
        if args:
            ev["args"] = args
        _trace.append(ev)


def trace_counter(name: str, value: float) -> None:
    """One sample of a counter track ('C'), stamped now."""
    if _trace is None:
        return
    with _trace_lock:
        if _trace is None:
            return
        _trace.append({
            "ph": "C", "name": name, "pid": 1,
            "ts": time.perf_counter() * 1e6, "args": {name: value},
        })


class _Substep:
    __slots__ = ("name", "batch", "t0")

    def __init__(self, name: str, batch: Optional[int]) -> None:
        self.name = name
        self.batch = batch

    def __enter__(self) -> "_Substep":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        trace_span(self.name, self.t0, time.perf_counter() - self.t0,
                   args=None if self.batch is None
                   else {"batch": self.batch})


class _NullSubstep:
    __slots__ = ()

    def __enter__(self) -> "_NullSubstep":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SUBSTEP = _NullSubstep()


def substep(name: str, span=None):
    """A child span inside a stage, on the calling thread's track, with
    the batch id of ``span`` (a BatchSpan); a no-op unless armed."""
    if _trace is None:
        return _NULL_SUBSTEP
    return _Substep(name, getattr(span, "batch_id", None))


def gc_pause(thread: str, t0: float, seconds: float, generation: int,
             collected: int) -> None:
    """One collection, reported by the gc callback: kept aside while
    armed and written as a ``gc`` span on ``thread``'s track when the
    trace stops. Takes no lock (see ``_gc_spans``)."""
    if _trace is not None:
        _gc_spans.append((thread, t0, seconds, generation, collected))


# -- the card's own time per kernel launch --------------------------------

def collect_launches() -> Optional[list]:
    """While the trace is armed on the card: route the kernel launches
    this thread makes until ``close_launches`` into the returned list,
    as (kernel, start event, end event). None otherwise."""
    if _trace is None or _anchor is None:
        return None
    sink: list = []
    _launch_local.sink = sink
    return sink


def close_launches() -> None:
    _launch_local.sink = None


def launch_begin():
    """At a launch site, right before the launch: a timing event on the
    current stream when this thread collects launches on the anchor's
    device; else None."""
    if getattr(_launch_local, "sink", None) is None:
        return None
    anchor = _anchor
    torch = sys.modules["torch"]
    if anchor is None or torch.cuda.current_device() != anchor[0]:
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return start


def launch_end(start, kernel: str) -> None:
    """Right after the launch, before anything else is enqueued on the
    stream: the end event, kept with ``start`` in this thread's list."""
    sink = getattr(_launch_local, "sink", None)
    if sink is None:
        return
    end = sys.modules["torch"].cuda.Event(enable_timing=True)
    end.record()
    sink.append((kernel, start, end))


def device_spans(launched, name: str, args: dict) -> None:
    """The launches as spans on the ``device`` track, in perf_counter
    seconds: a start is the anchor's perf_counter plus the card's time
    from the anchor event to the launch's start event. Called once the
    launch's result is on the host, so both events have completed and
    the synchronize below returns at once."""
    anchor = _anchor
    if not launched or anchor is None or _trace is None:
        return
    _, event0, t_anchor = anchor
    for kernel, start, end in launched:
        end.synchronize()
        t0 = t_anchor + event0.elapsed_time(start) / 1e3
        trace_span(name, t0, start.elapsed_time(end) / 1e3,
                   track="device", args={**args, "kernel": kernel})


def stop_trace() -> List[dict]:
    """Disarm and return the collected events, the collections among
    them, closed by a second ``clock_sync``."""
    global _trace, _anchor
    with _trace_lock:
        events = _trace
        if events is not None:
            for thread, t0, dur, generation, collected in list(_gc_spans):
                events.append({
                    "ph": "X", "name": "gc", "pid": 1,
                    "tid": _tid_for(thread),
                    "ts": t0 * 1e6, "dur": dur * 1e6,
                    "args": {"generation": generation,
                             "collected": collected},
                })
            events.append(_clock_sync("stop"))
        _trace, _anchor = None, None
        _gc_spans.clear()
        _trace_tids.clear()
    return events or []


def export_chrome_trace(path: str) -> int:
    """Write the armed buffer as Chrome-trace JSON (the object form,
    which Perfetto and chrome://tracing both load) and disarm. Returns
    the event count."""
    events = stop_trace()
    with open(path, "w") as f:
        json.dump(
            {"traceEvents": events, "displayTimeUnit": "ms"}, f
        )
    return len(events)
