"""Permit-phase waiting pods (reference framework/v1alpha1/waiting_pods_map.go).

A pod whose Permit plugins return WAIT parks here until every pending
plugin allows it, any plugin rejects it, or its timeout fires. This is the
gang-scheduling hook: the coscheduling plugin holds group members in WAIT
until the whole group is assigned, then allows them all.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.framework.interface import Status, StatusCode


class WaitingPod:
    """Reference waiting_pods_map.go:50 (waitingPod)."""

    def __init__(self, pod: Pod, plugin_timeouts: Dict[str, float], now=time.monotonic):
        self.pod = pod
        self._lock = threading.Lock()
        self._now = now
        # plugin name -> absolute deadline
        self._pending: Dict[str, float] = {
            name: now() + timeout for name, timeout in plugin_timeouts.items()
        }
        self._event = threading.Event()
        self._status: Optional[Status] = None

    def get_pending_plugins(self) -> list:
        with self._lock:
            return list(self._pending)

    def allow(self, plugin_name: str) -> None:
        with self._lock:
            self._pending.pop(plugin_name, None)
            if self._pending:
                return
            if self._status is None:
                self._status = Status(StatusCode.SUCCESS)
        self._event.set()

    def reject(self, plugin_name: str, msg: str) -> None:
        with self._lock:
            if self._status is None:
                self._status = Status(
                    StatusCode.UNSCHEDULABLE, f"pod rejected by {plugin_name}: {msg}"
                )
        self._event.set()

    def wait(self) -> Status:
        """Block until allowed/rejected/timeout; returns the final Status.
        Reference framework.go WaitOnPermit."""
        while True:
            with self._lock:
                if self._status is not None:
                    return self._status
                if not self._pending:
                    return Status(StatusCode.SUCCESS)
                deadline = min(self._pending.values())
                remaining = deadline - self._now()
                if remaining <= 0:
                    self._status = Status(
                        StatusCode.UNSCHEDULABLE,
                        "pod rejected due to timeout after waiting at permit",
                    )
                    return self._status
            # allow()/reject() always set the event; a deadline can only be
            # the earliest-pending min, so sleeping until it is safe.
            self._event.wait(timeout=remaining)
            self._event.clear()


class WaitingPodsMap:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._pods: Dict[str, WaitingPod] = {}  # uid -> WaitingPod

    def __len__(self) -> int:
        # len()/truthiness mirror the underlying map so hot paths can ask
        # "any Permit waiters at all?" without taking the lock per pod
        return len(self._pods)

    def add(self, wp: WaitingPod) -> None:
        with self._lock:
            self._pods[wp.pod.metadata.uid] = wp

    def remove(self, uid: str) -> None:
        with self._lock:
            self._pods.pop(uid, None)

    def get(self, uid: str) -> Optional[WaitingPod]:
        with self._lock:
            return self._pods.get(uid)

    def iterate(self, fn) -> None:
        with self._lock:
            for wp in list(self._pods.values()):
                fn(wp)
