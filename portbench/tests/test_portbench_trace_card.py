"""On the card: the spread cell, traced at its tiny size, reads every
per-layer metric and puts K2's device time on the program's clock. Run
on the H100 with

    python3 -m pytest portbench/tests -m card -q -s
"""

import pytest

from portbench import harness, spec

#: the per-layer metrics that read the program's own spans and counters
#: of where the window's time goes
TRACE_METRICS = (
    "drain_wait_us_per_pod.burst", "window_wait_us_per_pod.burst",
    "queue_depth_at_pop.burst", "ingest_us_per_pod.burst",
    "gc_pause_us_per_pod.burst", "k2_device_us_per_pod.burst",
)
#: microseconds a K2 span may stray from its batch's host stages (the
#: clock anchor's error, a few microseconds)
SLACK_US = 50.0


@pytest.mark.card
def test_the_traced_spread_cell_puts_k2_on_the_programs_clock():
    """The spread cell at its tiny size, traced for 12 s (one in-flight
    collection falls at +10 s): every per-layer metric reads, and each
    K2 launch has one span on the program's device track, inside its
    batch's [device_solve start, download end], and the window holds as
    many as the profiler saw; the start offsets from the profiler's
    intervals, as the harness maps them, are printed."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card is visible")
    from portbench.tests._tiny import scale_for

    cell = spec.load_cell("spread-5000.burst5k")
    run = harness.run_cell(cell, 2**31 + 7, 12.0, True,
                           scale=scale_for(cell.name))
    result = harness.finish(run)
    assert result["correct"], result["checks"]
    missing = [m.name for m in cell.per_layer
               if m.name not in result["metrics"]]
    assert not missing, missing
    k2 = [e for e in run.host_spans
          if e.get("args", {}).get("kernel") == "K2"]
    assert len({e["args"]["batch"] for e in k2}) == len(k2)
    stages = {}
    for e in run.host_spans:
        if e["name"] in ("device_solve", "download"):
            stages.setdefault(e["args"]["batch"], {})[e["name"]] = e
    for e in k2:
        st = stages[e["args"]["batch"]]
        lo = st["device_solve"]["ts"] - SLACK_US
        hi = st["download"]["ts"] + st["download"]["dur"] + SLACK_US
        assert lo <= e["ts"] <= e["ts"] + e["dur"] <= hi, (e, st)
    prof = sorted((s, e) for name, s, e in run.device.ops
                  if "constrained_cluster_kernel" in name
                  and run.t0 <= s <= run.t1)
    starts = [e["ts"] / 1e6 for e in k2]
    inside = sum(1 for t in starts if run.t0 <= t <= run.t1)
    # a launch at either edge of the window may fall in one count only
    assert prof and abs(inside - len(prof)) <= 2, (inside, len(prof))
    offsets = [min(abs(t - s) for t in starts) * 1e6 for s, _ in prof]
    print(f"K2 launches {len(prof)}, spans {inside}, start offset "
          f"median {sorted(offsets)[len(offsets) // 2]:.1f} us, largest "
          f"{max(offsets):.1f} us; "
          + ", ".join(f"{m} {result['metrics'][m]['value']:.3f}"
                      for m in TRACE_METRICS))
