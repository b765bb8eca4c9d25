"""Scheduling queue (reference pkg/scheduler/internal/queue/)."""

from kubernetes_tpu_torch.queue.heap import Heap
from kubernetes_tpu_torch.queue.scheduling_queue import PriorityQueue
from kubernetes_tpu_torch.queue import events

__all__ = ["Heap", "PriorityQueue", "events"]
