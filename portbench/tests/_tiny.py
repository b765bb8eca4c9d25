"""Tiny sizes at which each cell of ``BENCHMARK.json`` runs end to end
on the CPU, through the port's plain PyTorch versions of its kernels."""

from portbench import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SCALE = {"nodes.count": 40, "setup_pods.count": 30,
         "scheduler.max_batch": 64, "traffic.burst": 150,
         "traffic.chunk": 32}
#: the configuration's maxSkew of 5 binds on some seeds only at 40 nodes
#: (it binds on every seed at the cell's own size); a skew of 1 always does
SPREAD = [{"max_skew": 1, "topology_key": "topology.kubernetes.io/zone",
           "match_labels": {"app": "spread"}}]


def scale_for(cell):
    scale = dict(SCALE)
    if cell.startswith("spread"):
        scale["pod.spread"] = SPREAD
    return scale


def run_tiny(cell, seed, seconds=1.5, trace=False):
    return harness.run_cell(spec.load_cell(cell), seed, seconds, trace,
                            device="cpu", scale=scale_for(cell))
