"""Each cell end to end at a tiny size on the CPU, judged by the
reference; and the controls, the reference with a guarantee broken put
in the program's place, refused."""

import pytest

from portbench import harness
from portbench.controls import ties_to_the_last_row, without_spread
from portbench.tests._tiny import CELLS, run_tiny
from portbench.workload import node_zone


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_is_correct(cell, trace):
    run = run_tiny(cell, 2**31 + 17, trace=trace)
    result = harness.finish(run)
    assert result["correct"], result["checks"]
    assert result["attempted"] == len(run.order) > 0
    assert result["failed"] == 0
    names = {m.name for m in (run.cell.per_layer if trace
                              else run.cell.end_to_end)}
    assert set(result["metrics"]) <= names
    assert "setup_s" in result["metrics"] or trace
    assert list(result)[-1] == "checks"


def test_the_spread_filter_binds_at_the_tiny_size():
    run = run_tiny("spread-5000.burst5k", 5)
    zones = {}
    for n in run.bursts[0].names:
        z = node_zone(run.config, int(run.bound[n][1].split("-")[1]))
        zones[z] = zones.get(z, 0) + 1
    assert len(zones) == run.config["nodes"]["zones"]
    assert max(zones.values()) - min(zones.values()) <= 1
    assert harness.finish(run)["correct"]
    # the reference with the filter dropped, in the program's place
    assert harness.judge(run, without_spread(run),
                         harness.expected_nodes(run))["misplaced"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_refused(cell):
    run = run_tiny(cell, 99)
    control = ties_to_the_last_row(run)
    checks = harness.judge(run, control, harness.expected_nodes(run))
    assert checks["misplaced"] > harness.CHECK_LIMITS["misplaced"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_pod_maker_builds_the_wrappers_pod(cell):
    from portbench import spec
    from portbench.workload import PodMaker, make_pod

    template = spec.load_cell(cell).config["pod"]
    made, wrapped = PodMaker(template)("p-1"), make_pod(template, "p-1")
    for pod in (made, wrapped):
        pod.metadata.uid, pod.metadata.creation_timestamp = "u", 0.0
    assert made == wrapped
