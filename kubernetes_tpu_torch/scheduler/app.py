"""The process shell: config -> wired scheduler + serving + HA.

Reference: /root/reference/cmd/kube-scheduler/app/server.go (Run :164:
event broadcaster, healthz :203-214, metrics :220, informer start, leader
election :241-247, sched.Run) and options loading.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.config.types import KubeSchedulerConfiguration
from kubernetes_tpu_torch.scheduler.debugger import CacheDebugger
from kubernetes_tpu_torch.scheduler.leaderelection import LeaderElector
from kubernetes_tpu_torch.scheduler.resilience import (
    ControlPlaneReconciler,
    recover_on_startup,
)
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler, new_scheduler
from kubernetes_tpu_torch.utils import flightrecorder, metrics

logger = logging.getLogger(__name__)


class _OpsHandler(BaseHTTPRequestHandler):
    app: "SchedulerApp"

    def log_message(self, *a):  # quiet
        pass

    def _reply(self, code: int, body: str, ctype: str = "text/plain") -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, "ok")
        elif self.path == "/metrics":
            # refresh state gauges at scrape time (pending_pods,
            # scheduler_cache_size -- metrics.go:155, :230)
            for queue_name, n in self.app.sched.queue.num_pending().items():
                metrics.pending_pods.set(n, queue=queue_name)
            metrics.cache_size.set(self.app.sched.cache.node_count(), type="nodes")
            metrics.cache_size.set(self.app.sched.cache.pod_count(), type="pods")
            self._reply(
                200, metrics.registry.expose(), "text/plain; version=0.0.4"
            )
        elif self.path == "/debug/flightrecorder":
            # the last-K batch spans + control-plane marks, as JSON:
            # chaos e2es and operators reconstruct "what happened to
            # batch N" from here instead of grepping logs
            self._reply(
                200, flightrecorder.RECORDER.dump_json(indent=1),
                "application/json",
            )
        elif self.path == "/debug/cache":
            self._reply(200, self.app.debugger.dumper.dump_all())
        elif self.path == "/debug/comparer":
            self._reply(
                200, json.dumps(self.app.debugger.comparer.compare(), indent=1)
            )
        else:
            self._reply(404, "not found")


class SchedulerApp:
    """One scheduler process: serving + (optional) leader election around
    the scheduling loop."""

    def __init__(
        self,
        config: Optional[KubeSchedulerConfiguration] = None,
        server: Optional[APIServer] = None,
        batch: bool = True,
        device=None,
    ) -> None:
        self.config = config or KubeSchedulerConfiguration()
        self.server = server or APIServer()
        self.client = Client(self.server)
        self.informers = InformerFactory(self.server)
        self.identity = f"scheduler-{uuid.uuid4().hex[:8]}"
        from kubernetes_tpu_torch.robustness.faults import (
            injector_from_configuration,
            install_injector,
        )
        from kubernetes_tpu_torch.robustness.ladder import RobustnessConfig

        self.sched: Scheduler = new_scheduler(
            self.client,
            self.informers,
            profiles=self.config.profiles or None,
            percentage_of_nodes_to_score=(
                self.config.percentage_of_nodes_to_score
            ),
            batch=batch,
            extenders=getattr(self.config, "extenders", None),
            robustness_config=RobustnessConfig.from_configuration(
                self.config.robustness
            ),
            device=device,
        )
        from kubernetes_tpu_torch.scheduler.scheduler import (
            apply_streaming_config,
        )

        apply_streaming_config(
            self.sched, self.config, self.informers, batch=batch,
            max_batch=getattr(self.sched, "max_batch", 256),
        )
        injector = injector_from_configuration(self.config.fault_injection)
        if injector is not None:
            install_injector(injector)
        self.debugger = CacheDebugger(
            self.client,
            self.sched.cache,
            self.sched.queue,
            tensor_cache=getattr(self.sched, "tensor_cache", None),
            snapshot=self.sched.algorithm.snapshot,
        )
        self.elector: Optional[LeaderElector] = None
        self.coordinator = None
        if getattr(self.config, "partition", None) is not None and (
            self.config.partition.enabled
        ):
            raise ValueError(
                "partitioned multi-active mode is not ported yet: it "
                "arrives in a later slice of the port (ROADMAP Queue 1 "
                "item 8)"
            )
        # multi-tenant fairness plane (scheduler/tenancy.py): the
        # ResourceQuota admission gate + DRF dominant-share bias.
        # Constructed here so the controller's informer handlers see the
        # very first watch frames; sync_all + the loop start in start().
        self.quota_controller = None
        tn = getattr(self.config, "tenancy", None)
        if tn is not None and tn.enabled:
            raise ValueError(
                "the multi-tenant fairness plane is not ported yet: it "
                "arrives in a later slice of the port (ROADMAP Queue 1 "
                "item 8)"
            )
        self.reconciler: Optional[ControlPlaneReconciler] = None
        self.recovery_report = None
        self._http: Optional[ThreadingHTTPServer] = None
        self._threads = []

    # -- serving (server.go:203-224) ----------------------------------------

    def start_serving(self) -> Tuple[str, int]:
        handler = type("Handler", (_OpsHandler,), {"app": self})
        addr = self.config.health_bind_address or "127.0.0.1:0"
        host, _, port = addr.partition(":")
        self._http = ThreadingHTTPServer((host, int(port or 0)), handler)
        t = threading.Thread(target=self._http.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        return self._http.server_address[:2]

    # -- run (server.go:164) -------------------------------------------------

    def start(self) -> None:
        # SIGUSR1 -> flight-recorder dump to disk (the kill -USR1 "what
        # is it doing right now" probe); only installable from the main
        # thread, and never required for correctness
        try:
            signal.signal(
                signal.SIGUSR1,
                lambda signum, frame: flightrecorder.RECORDER.dump_to_file(
                    "sigusr1"
                ),
            )
        except (ValueError, AttributeError, OSError):
            pass  # non-main thread or platform without SIGUSR1
        if self.coordinator is not None:
            # claim partitions BEFORE the informers sync so the event
            # handlers filter the very first frames against a live
            # ownership set (start() runs one synchronous claim round)
            self.coordinator.start()
        self.informers.start()
        self.informers.wait_for_cache_sync()
        # Crash recovery (scheduler/resilience.py): the relist above
        # rebuilt cache/queue; verify it against apiserver ground truth,
        # adopt anything a previous incarnation bound, and meter it.
        self.recovery_report = recover_on_startup(self.sched, self.client)
        if self.quota_controller is not None:
            # rebuild the namespace ledgers from relisted ground truth
            # (bound pods re-adopt their charges), then run the
            # event-driven headroom/release loop
            self.quota_controller.sync_all()
            self.quota_controller.start()
        # Freeze the synced cluster graph out of cyclic-GC scanning
        # (utils/gc_tuning.py rationale).
        from kubernetes_tpu_torch.utils.gc_tuning import freeze_steady_state_graph

        freeze_steady_state_graph()
        rs = self.config.resilience
        if rs.sweeper_enabled:
            self.reconciler = ControlPlaneReconciler(
                self.sched,
                self.client,
                sweep_interval=rs.sweep_interval_seconds,
                drift_interval=rs.drift_check_interval_seconds,
            )
            self.reconciler.start()
        if self.coordinator is not None:
            self.sched.start()
        elif self.config.leader_election.leader_elect:
            self.elector = LeaderElector(
                self.client,
                self.config.leader_election,
                self.identity,
                on_started_leading=lambda: self.sched.run(),
                on_stopped_leading=self.sched.stop,
            )
            if rs.commit_fencing:
                # commit-time fencing: the committer re-verifies lease
                # ownership immediately before every bulk bind
                self.sched.fencing_check = self.elector.holds_lease
            t = threading.Thread(target=self.elector.run, daemon=True)
            t.start()
            self._threads.append(t)
        else:
            self.sched.start()

    def stop(self) -> None:
        if self.quota_controller is not None:
            self.quota_controller.stop()
        if self.reconciler is not None:
            self.reconciler.stop()
        if self.coordinator is not None:
            # graceful: release the partition leases so siblings adopt
            # immediately instead of waiting out the lease duration.
            # A SIMULATED crash (sched.crashed) abandons them instead --
            # a dead process can't release, and the takeover path is
            # exactly what the chaos harness is measuring.
            self.coordinator.stop(release=not self.sched.crashed)
        if self.elector is not None:
            self.elector.stop()
            self.elector.release()
        self.sched.stop()
        self.informers.stop()
        if self._http is not None:
            self._http.shutdown()
