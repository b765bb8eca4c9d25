"""The scheduler binary: flags -> config -> process shell.

Reference: cmd/kube-scheduler (cobra command over app/options ->
app.Run, server.go:70/:164). The same layering here: argparse flags
override the YAML KubeSchedulerConfiguration, an optional legacy Policy
file translates to a profile (factory.go:239), feature gates parse from
--feature-gates, and SchedulerApp wires serving + optional leader
election around the scheduling loop.

Run: python -m kubernetes_tpu_torch --config cfg.yaml [--healthz-bind-address
127.0.0.1:10251] [--leader-elect] [--policy-config-file policy.yaml]
[--feature-gates Gate=true,...]
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def parse_feature_gates(raw: str):
    out = {}
    for part in filter(None, (p.strip() for p in raw.split(","))):
        key, _, val = part.partition("=")
        if val.lower() not in ("true", "false"):
            raise SystemExit(
                f"--feature-gates: {part!r} must be <name>=true|false"
            )
        out[key] = val.lower() == "true"
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kubernetes_tpu_torch",
        description="TPU-native cluster scheduler (kube-scheduler analogue)",
    )
    ap.add_argument("--config", help="KubeSchedulerConfiguration YAML")
    ap.add_argument(
        "--policy-config-file",
        help="legacy v1 Policy file, translated to a profile",
    )
    ap.add_argument("--healthz-bind-address", default=None)
    ap.add_argument("--metrics-bind-address", default=None)
    ap.add_argument(
        "--leader-elect", action="store_true", default=None,
        help="enable active/passive leader election",
    )
    ap.add_argument("--feature-gates", default="")
    ap.add_argument(
        "--percentage-of-nodes-to-score", type=int, default=None
    )
    ap.add_argument(
        "--manifest", action="append", default=[],
        help="YAML manifest(s) of Pods/Nodes/PDBs/PodGroups/Services to "
        "create at boot (the in-proc control plane's seed state)",
    )
    ap.add_argument(
        "--fault-profile", default="",
        help="named fault-injection profile (chaos runs; see "
        "kubernetes_tpu_torch/robustness/faults.py builtin_profiles)",
    )
    ap.add_argument(
        "--fault-seed", type=int, default=0,
        help="seed for the fault-injection RNG streams",
    )
    ap.add_argument("-v", "--verbose", action="count", default=0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )

    from kubernetes_tpu_torch.config.loader import (
        DEFAULT_FEATURE_GATES,
        FeatureGate,
        load_config,
    )
    from kubernetes_tpu_torch.config.types import KubeSchedulerConfiguration
    from kubernetes_tpu_torch.scheduler.app import SchedulerApp

    cfg = (
        load_config(args.config)
        if args.config
        else KubeSchedulerConfiguration()
    )
    if args.policy_config_file:
        from kubernetes_tpu_torch.config.policy import load_policy

        cfg.profiles = [load_policy(args.policy_config_file)]
    if args.healthz_bind_address is not None:
        cfg.health_bind_address = args.healthz_bind_address
    if args.metrics_bind_address is not None:
        cfg.metrics_bind_address = args.metrics_bind_address
    if args.leader_elect is not None:
        cfg.leader_election.leader_elect = args.leader_elect
    if args.percentage_of_nodes_to_score is not None:
        cfg.percentage_of_nodes_to_score = args.percentage_of_nodes_to_score

    gates = FeatureGate(DEFAULT_FEATURE_GATES)
    # precedence matches every other flag: YAML first, CLI overrides
    overrides = dict(cfg.feature_gates)
    overrides.update(parse_feature_gates(args.feature_gates))
    try:
        gates.set_from_map(overrides)
    except ValueError as e:
        raise SystemExit(f"--feature-gates: {e}") from None

    if args.fault_profile:
        from kubernetes_tpu_torch.robustness.faults import (
            FaultInjector,
            install_injector,
            load_profile,
        )

        try:
            profile = load_profile(
                args.fault_profile, seed=args.fault_seed
            )
        except KeyError as e:
            raise SystemExit(f"--fault-profile: {e.args[0]}") from None
        install_injector(FaultInjector(profile))

    app = SchedulerApp(
        config=cfg, batch=gates.enabled("TPUBatchSolver")
    )
    if args.manifest:
        from kubernetes_tpu_torch.api.serialization import load_manifest

        for path in args.manifest:
            try:
                for obj in load_manifest(path):
                    app.server.create(obj)
            except Exception as e:  # noqa: BLE001 - operator-facing
                raise SystemExit(f"--manifest {path}: {e}") from None
    host, port = app.start_serving()
    logging.getLogger("kubernetes_tpu_torch").info(
        "serving healthz/metrics on %s:%s", host, port
    )
    app.start()

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    app.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
