"""What the harness loads, and how it finds a cell.

The harness and everything a run of it loads hold no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``kubernetes_tpu``
(compared whole: ``kubernetes_tpu_torch`` begins with ``kubernetes_tpu``);
the reference loads none of the program either. A cell, a configuration
and a per-layer metric dropped in as files of their own are found by
name, with no file that is there edited."""

import json
import os
import shutil
import subprocess
import sys

from portbench import harness, spec
from portbench.tests._tiny import CELLS, scale_for

ROOT = spec.ROOT

_LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level_names(body):
    out = subprocess.run(
        [sys.executable, "-c", _LOADED.format(root=ROOT, body=body)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_the_harness_loads_no_jax():
    names = _top_level_names(
        "from portbench import harness, spec\n"
        "import portbench.__main__, portbench.devtrace\n"
        f"cell = spec.load_cell({CELLS[0]!r})\n"
        f"run = harness.run_cell(cell, 3, 1.0, True, device='cpu', scale={scale_for(CELLS[0])!r})\n"
        "assert harness.finish(run)['correct']\n"
        "assert not harness.forbidden_loaded()\n")
    assert "kubernetes_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "kubernetes_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_names(
        "import portbench.reference, portbench.reference.scheduler\n"
        "import portbench.arrivals, portbench.roofline, portbench.readers\n")
    assert not names & {"jax", "jaxlib", "flax", "kubernetes_tpu",
                        "kubernetes_tpu_torch"}


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kubernetes_tpu_torchlike", sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_loaded() == ["jax.numpy"]


def test_new_files_and_entries_add_a_cell_a_config_and_a_metric(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, spec.PKG_NAME), root / spec.PKG_NAME,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    pkg = root / spec.PKG_NAME
    config = json.loads((pkg / "configs" / "spread-5000.json").read_text())
    nodes = {k: v for k, v in config["nodes"].items()
             if k not in ("zones", "zone_label")}
    config.update(name="basic-48", nodes=dict(nodes, count=48),
                  pod={k: v for k, v in config["pod"].items() if k != "spread"})
    (pkg / "configs" / "basic-48.json").write_text(json.dumps(config))
    (pkg / "traffic" / "burst64.json").write_text(json.dumps(
        {"kind": "closed", "burst": 64, "chunk": 16}))
    (pkg / "metrics" / "pods_created.probe.py").write_text(
        "def read(run):\n    return len(run.order)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "basic-48", "source": "https://example.org/basic-48",
        "file": "portbench/configs/basic-48.json", "reduced": [],
        "why": "a probe"})
    bench["workloads"].append({
        "name": "basic-48.burst64", "config": "basic-48",
        "traffic": "burst64", "chips": 1, "why": "a probe"})
    bench["per_layer"].append({
        "name": "pods_created.probe", "unit": "pods", "better": "higher",
        "source": "host_clock", "layer": "probe", "moves": "pods_per_s",
        "workloads": ["basic-48.burst64"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "pods_per_s" == m["name"]:
            m["workloads"].append("basic-48.burst64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    changed = [p for p, b in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []
    cell = spec.load_cell("basic-48.burst64", root=str(root))
    assert cell.traffic["burst"] == 64 and cell.config["nodes"]["count"] == 48
    assert [m.name for m in cell.per_layer] == ["pods_created.probe"]
    scale = {"setup_pods.count": 20, "scheduler.max_batch": 32}
    run = harness.run_cell(cell, 8, 1.0, True, device="cpu", scale=scale)
    result = harness.finish(run)
    assert result["correct"]
    assert result["metrics"]["pods_created.probe"]["value"] == len(run.order)
    plain = harness.run_cell(cell, 8, 1.0, False, device="cpu", scale=scale)
    assert set(harness.finish(plain)["metrics"]) == {"pods_per_s", "setup_s"}


def test_every_metric_finds_its_reader_and_a_split_one_shares_its_stem():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))
    burst = spec.load_reader("pack_us_per_pod.burst")
    tail = spec.load_reader("pack_us_per_pod.tail")
    assert burst.__module__ == tail.__module__ == "portbench.metrics.pack_us_per_pod"
