"""Sinkhorn optimal-transport assignment prior.

The greedy scan (ops/assignment.py) is the parity-mode solver: it replays
the reference's sequential argmax exactly. For the churn/rebalance regime
(BASELINE.json config #5: 50k-node x 100k-pod churn + descheduler
rebalance) a myopic per-pod argmax packs poorly: early pods grab globally
contested nodes. Sinkhorn computes a soft transport plan between the pod
batch (unit demand each) and node slot capacities, giving every pod a
globally-aware placement prior; the final commitment still runs through
the capacity-replay commit scan (on the card: the greedy-solve kernel's
scored entry, ops/greedy_kernel.py), so feasibility is never soft.

The plan is plain torch tensor ops on the tensors' own device (the JAX
package computes it outside any Pallas kernel too): 50 log-space
iterations, each a row ``logsumexp`` over the node axis and a
capacity-capped column ``logsumexp`` over the pod axis.

Not bit-exact to the JAX package (ROADMAP Queue 3 item 7): a
``logsumexp`` is a max, a sum of exponentials and a log, and torch and
XLA reduce in different orders (and XLA fuses the exponentials into the
reduction), so each reduction may round differently in its last bits,
and 50 iterations carry that forward. On seeded batches the plan agrees
to ~4e-8 absolute (the 1e4-scaled prior to ~4e-4); the tests hold the
plan to 1e-6 and the prior to 1e-2, and the commit scan, given one
prior, bit for bit.
"""

from __future__ import annotations

import torch

NEG = -1e9
ITERS = 50
TAU = 20.0
PRIOR_SCALE = 1e4


def sinkhorn_plan(
    score: torch.Tensor,  # [B, N] float32 (higher = better)
    feasible: torch.Tensor,  # [B, N] bool
    node_slots: torch.Tensor,  # [N] float32 estimated free pod slots
    active: torch.Tensor,  # [B] bool
    iters: int = ITERS,
    tau: float = TAU,
) -> torch.Tensor:
    """Entropic-OT transport plan in log space, on the inputs' device.

    Rows (pods) have unit mass; columns (nodes) are capped at
    ``node_slots``. Returns the plan [B, N] (mass in [0, 1]); infeasible
    cells carry ~0 mass. Rows where ``active`` is False keep f = 0."""
    log_k = torch.where(feasible, score / tau, NEG)
    log_k = torch.where(active[:, None], log_k, NEG)
    log_slots = torch.log(torch.clamp(node_slots, min=1e-6))
    f = torch.zeros(score.shape[0], dtype=torch.float32, device=score.device)
    g = torch.zeros(score.shape[1], dtype=torch.float32, device=score.device)
    for _ in range(iters):
        # rows: unit mass each
        f = -torch.logsumexp(log_k + g[None, :], dim=1)
        f = torch.where(active, f, 0.0)
        # columns: capacity-capped (never force mass INTO a column --
        # unbalanced OT: g <= the capped value)
        col = torch.logsumexp(log_k + f[:, None], dim=0)
        g = torch.clamp(log_slots - col, max=0.0)
    return torch.exp(log_k + f[:, None] + g[None, :])


def refine_scores(
    score: torch.Tensor,
    feasible: torch.Tensor,
    node_slots: torch.Tensor,
    active: torch.Tensor,
    iters: int = ITERS,
    tau: float = TAU,
) -> torch.Tensor:
    """Scale the transport plan into a score matrix for the commit scan.
    The commit scan adds its own DYNAMIC resource score as the
    tie-breaker (with within-batch load feedback); appending the static
    score here would double-count it."""
    plan = sinkhorn_plan(score, feasible, node_slots, active, iters, tau)
    return plan * PRIOR_SCALE
