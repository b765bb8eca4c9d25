"""Placements that the check has to refuse, each put in the program's
place: the reference with one guarantee of the configuration broken.

* ``ties_to_the_last_row``: the lowest row no longer wins a tie, the
  highest does, as a parallel argmax keeping whichever tied row lands
  last would. This is the control of every cell.
* ``without_spread``: the pods' spread constraints dropped, as a solve
  that skips the spread filter would place them.

The scores in bfloat16 are no control here: at the configurations'
widths every node's score is a function of its pod count that bfloat16
orders as float32 does, so the placements are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from portbench import harness


def ties_to_the_last_row(run) -> Dict[str, Optional[str]]:
    """The reference's nodes for ``run``'s pods with the rows reversed, so
    the highest row of the run wins every tie, set-up's pods' included."""
    return harness.expected_nodes(
        dataclasses.replace(run, node_order=list(run.node_order)[::-1]))


def without_spread(run) -> Dict[str, Optional[str]]:
    """The reference's nodes for ``run``'s pods, spread constraints
    dropped."""
    config = dict(run.config, pod=dict(run.config["pod"], spread=[]))
    return harness.expected_nodes(dataclasses.replace(run, config=config))
