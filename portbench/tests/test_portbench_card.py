"""On the card: every cell runs correct, and its controls, the reference
with a guarantee broken put in the program's place at the cell's own
size, are refused, on three seeds each: ties to the last row in every
cell, the spread filter dropped where the pods spread. The reference in
bfloat16 is read beside them. Run on the H100 with

    python3 -m pytest portbench/tests -m card -q -s
"""

import pytest

from portbench import harness, spec
from portbench.controls import ties_to_the_last_row, without_spread
from portbench.reference.scheduler import BF16

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEEDS = [2**31 + 101, 2**32 + 202, 2**33 + 303]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_is_correct_and_its_control_refused(cell, seed):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card is visible")
    run = harness.run_cell(spec.load_cell(cell), seed, 5.0, False)
    result = harness.finish(run)
    assert result["correct"], result["checks"]
    want = harness.expected_nodes(run)
    control = harness.judge(run, ties_to_the_last_row(run), want)["misplaced"]
    dropped = None
    if run.config["pod"].get("spread"):
        dropped = harness.judge(run, without_spread(run), want)["misplaced"]
    bf16 = harness.judge(run, harness.expected_nodes(run, BF16), want)
    print(f"{cell} seed {seed}: program {result['checks']}; misplaced by "
          f"ties to the last row {control}, the spread filter dropped "
          f"{dropped}, bfloat16 {bf16['misplaced']}, of {len(run.order)}")
    assert control > harness.CHECK_LIMITS["misplaced"]
    assert dropped is None or dropped > harness.CHECK_LIMITS["misplaced"]
