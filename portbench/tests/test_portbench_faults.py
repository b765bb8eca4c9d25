"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the port's plain solve, which the CPU run
takes where the card takes K1 or K2: a step that returns its state
unchanged, half of each batch left out, and one answer altered where it
is produced. (One chip: no exchange between chips to leave out.)"""

import pytest
import torch

from portbench import harness
from portbench.tests._tiny import CELLS, run_tiny


def _unchanged_state(out, args):
    return out[0], args[1], args[2]


def _half_left_out(out, args):
    asg = out[0].clone()
    live = torch.nonzero(args[8]).flatten()
    asg[live[len(live) // 2:]] = -1
    return asg, out[1], out[2]


def _answer_altered(out, args):
    asg = out[0].clone()
    valid = args[3]
    placed = torch.nonzero(asg >= 0).flatten()
    if len(placed):
        t = int(placed[0])
        rows = torch.nonzero(valid).flatten()
        rows = rows[rows != int(asg[t])]
        asg[t] = int(rows[0])
    return asg, out[1], out[2]


FAULTS = {"unchanged_state": _unchanged_state, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_solve_is_not_correct(cell, fault, monkeypatch):
    from kubernetes_tpu_torch.ops import constrained_kernel, greedy_kernel

    break_ = FAULTS[fault]
    measure = harness._measure

    def measure_broken(*args, **kwargs):
        # the fault holds from the window's start: set-up ran sound
        for mod, name in ((greedy_kernel, "greedy_assign_compact"),
                          (constrained_kernel, "greedy_assign_constrained")):
            orig = getattr(mod, name)

            def broken(*a, _orig=orig, **kw):
                return break_(_orig(*a, **kw), a)

            monkeypatch.setattr(mod, name, broken)
        return measure(*args, **kwargs)

    monkeypatch.setattr(harness, "_measure", measure_broken)
    monkeypatch.setattr(harness, "GRACE_S", 2.0)
    run = run_tiny(cell, 7)
    result = harness.finish(run)
    assert not result["correct"], result["checks"]
