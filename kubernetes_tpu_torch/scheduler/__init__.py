"""Scheduler: the control loop(s).

Reference: /root/reference/pkg/scheduler/. Two execution profiles ship:

- the sequential host path (``scheduler.Scheduler.schedule_one``), a
  faithful port of scheduleOne semantics used as the correctness oracle;
- the batch path (``batch.BatchScheduler``), which drains the activeQ
  in batches and solves placement as one assignment problem on the card
  (kubernetes_tpu_torch.ops: one hand-written CUDA kernel per batch).
"""

from kubernetes_tpu_torch.scheduler.scheduler import Scheduler, new_scheduler

__all__ = ["Scheduler", "new_scheduler"]
