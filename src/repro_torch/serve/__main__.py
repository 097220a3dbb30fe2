"""CLI for the concurrent serving planner.

    PYTHONPATH=src python -m repro_torch.serve --n-requests 16 --policy latency-greedy
    PYTHONPATH=src python -m repro_torch.serve --topology random \
        --topology-kwargs '{"n_nodes": 30, "p": 0.2, "seed": 7}' \
        --source v1 --destination v30 --n-requests 32 --arrival poisson
    PYTHONPATH=src python -m repro_torch.serve --gateway --arrival poisson \
        --batch-window-s 0.5 --hold-model exp --duration-s 4 --retry

Prints a per-request admission table plus the round summary (acceptance
ratio, latency percentiles); ``--json`` additionally writes the summary and
per-request records to a file.

The default solver is ``bcd_torch`` on the card, bit-identical to the JAX
package's default ``bcd``.  ``--device`` names the device of the solvers that
take one (``cuda`` by default); without a card the CLI exits with the
solvers' error unless ``--device cpu`` is given.  Host solvers (``bcd``,
``exact``, ...) ignore it.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..core import solver_names, solver_supports

from .failures import generate_failures
from .gateway import GatewayConfig, ServeGateway
from .planner import ServePlanner, device_kwargs
from .policies import POLICY_NAMES
from .requests import ARRIVALS, HOLD_MODELS, generate_fleet
from .sim import ServeSim


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description="concurrent multi-request admission")
    ap.add_argument("--topology", default="nsfnet")
    ap.add_argument("--topology-kwargs", default=None,
                    help="JSON kwargs for the topology factory")
    ap.add_argument("--profile", default="resnet101")
    ap.add_argument("--profile-kwargs", default=None)
    ap.add_argument("--source", default="v4")
    ap.add_argument("--destination", default="v13")
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=2,
                    help="base batch size (spread x1/x2/x4 across the fleet)")
    ap.add_argument("--mode", default="IF", choices=("IF", "TR"))
    ap.add_argument("--train-share", type=float, default=0.0,
                    help="fraction of the fleet drawn as TR training chains "
                         "(overrides --mode per request; a dedicated seeded "
                         "stream keeps arrivals identical to the all-IF twin)")
    ap.add_argument("--K", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival", default="batch", choices=ARRIVALS)
    ap.add_argument("--rate-rps", type=float, default=1.0,
                    help="sustained chain executions/s per request (bandwidth demand)")
    ap.add_argument("--schedule", default="seq", choices=("seq", "pipe"),
                    help="execution schedule: seq (paper) or pipe "
                         "(microbatched pipeline, docs/pipeline.md)")
    ap.add_argument("--n-microbatches", type=int, default=1,
                    help="pipeline depth M for --schedule pipe")
    ap.add_argument("--policy", default="fcfs", choices=POLICY_NAMES)
    ap.add_argument("--solver", default="bcd_torch",
                    choices=sorted(solver_names()))
    ap.add_argument("--device", default="cuda",
                    help="device of the solvers that take one (dfts_torch, "
                         "bcd_torch): cuda (default) or cpu")
    ap.add_argument("--no-replan", action="store_true",
                    help="disable capacity-aware replanning on rejection")
    ap.add_argument("--sim", action="store_true",
                    help="event-driven dynamic admission with chain "
                         "departures (docs/sim.md) instead of one static round")
    ap.add_argument("--hold-model", default="none", choices=HOLD_MODELS,
                    help="holding-time model for --sim fleets: none = hold "
                         "forever, fixed / exp = --duration-s holds")
    ap.add_argument("--duration-s", type=float, default=None,
                    help="holding time (fixed) or mean holding time (exp)")
    ap.add_argument("--retry", action="store_true",
                    help="--sim/--gateway: queue capacity-blocked requests "
                         "and retry them when a departure frees room")
    ap.add_argument("--gateway", action="store_true",
                    help="stream the fleet through the long-running "
                         "ServeGateway (batched ticks, warm plan cache, "
                         "docs/gateway.md) instead of one static round")
    ap.add_argument("--batch-window-s", type=float, default=0.0,
                    help="--gateway: group arrivals within this window into "
                         "one presolved admission tick")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="--gateway: bounded admission queue; submissions "
                         "beyond it are rejected with reason queue-full")
    ap.add_argument("--slo-latency-s", type=float, default=None,
                    help="--gateway: reject chains whose planned latency "
                         "exceeds this SLO (before committing capacity)")
    ap.add_argument("--failure-rate", type=float, default=0.0,
                    help="--sim/--gateway: substrate failure events per "
                         "second (docs/failures.md); 0 = no failures")
    ap.add_argument("--failure-downtime-s", type=float, default=None,
                    help="mean downtime before a failed resource recovers "
                         "(default: resources stay down)")
    ap.add_argument("--ha", action="store_true",
                    help="--sim/--gateway: pre-plan a disjoint standby for "
                         "every chain, promoted on failure")
    ap.add_argument("--json", default=None, help="write summary + records here")
    args = ap.parse_args(argv)
    if args.sim and args.gateway:
        ap.error("--sim and --gateway are mutually exclusive")
    if args.hold_model != "none" and args.duration_s is None:
        ap.error(f"--hold-model {args.hold_model} requires --duration-s")
    if args.duration_s is not None and args.hold_model == "none":
        ap.error("--duration-s requires --hold-model fixed|exp "
                 "(it would be silently ignored otherwise)")
    if ((args.hold_model != "none" or args.duration_s is not None
         or args.retry) and not (args.sim or args.gateway)):
        ap.error("--hold-model/--duration-s/--retry only apply with "
                 "--sim or --gateway")
    if ((args.batch_window_s != 0.0 or args.max_queue is not None
         or args.slo_latency_s is not None) and not args.gateway):
        ap.error("--batch-window-s/--max-queue/--slo-latency-s only apply "
                 "with --gateway")
    if ((args.failure_rate != 0.0 or args.failure_downtime_s is not None
         or args.ha) and not (args.sim or args.gateway)):
        ap.error("--failure-rate/--failure-downtime-s/--ha only apply with "
                 "--sim or --gateway")
    if args.failure_rate < 0:
        ap.error("--failure-rate must be >= 0")
    if not 0.0 <= args.train_share <= 1.0:
        ap.error("--train-share must be in [0, 1]")
    # No batch_size: the fleet's batch spread means some requests may pipeline
    # deeper than the base batch clamps, so check the unclamped depth.
    ok, reason = solver_supports(args.solver, schedule=args.schedule,
                                 n_microbatches=args.n_microbatches)
    if not ok:
        ap.error(reason)
    try:
        solver_kwargs = device_kwargs(args.solver, device=args.device)
    except (RuntimeError, ValueError) as exc:
        ap.error(f"{exc} (--device cpu)")

    from ..sweep.spec import build_profile, build_topology

    topo_kwargs = json.loads(args.topology_kwargs) if args.topology_kwargs else {}
    prof_kwargs = json.loads(args.profile_kwargs) if args.profile_kwargs else {}
    net = build_topology(args.topology, topo_kwargs)
    profile = build_profile(args.profile, prof_kwargs)

    fleet = generate_fleet(
        net, args.n_requests, args.source, args.destination, args.batch_size,
        args.mode, args.K, seed=args.seed, arrival=args.arrival,
        rate_rps=args.rate_rps, model_id=args.profile,
        schedule=args.schedule, n_microbatches=args.n_microbatches,
        hold_model=args.hold_model,
        hold_time_s=(args.duration_s if args.duration_s is not None
                     else float("inf")),
        ha=args.ha, train_share=args.train_share)
    failures = None
    if args.failure_rate > 0:
        horizon = (max(r.arrival_s for r in fleet)
                   + (args.duration_s if args.duration_s is not None else 10.0))
        failures = generate_failures(
            net, rate_per_s=args.failure_rate, horizon_s=horizon,
            seed=args.seed, mean_downtime_s=args.failure_downtime_s,
            protect=(args.source, args.destination))
    if args.sim:
        sim = ServeSim(net, profile, solver=args.solver,
                       replan=not args.no_replan, retry=args.retry,
                       solver_kwargs=solver_kwargs)
        outcome = sim.run(fleet, policy=args.policy, failures=failures)
    elif args.gateway:
        gw = ServeGateway(
            net, profile, solver=args.solver, replan=not args.no_replan,
            policy=args.policy, solver_kwargs=solver_kwargs,
            config=GatewayConfig(batch_window_s=args.batch_window_s,
                                 max_queue=args.max_queue,
                                 slo_latency_s=args.slo_latency_s,
                                 retry=args.retry))
        outcome = gw.run_stream(fleet, failures=failures)
    else:
        planner = ServePlanner(net, profile, solver=args.solver,
                               replan=not args.no_replan,
                               solver_kwargs=solver_kwargs)
        outcome = planner.admit(fleet, policy=args.policy)

    dynamic = args.sim or args.gateway
    extra = f" {'admit':>8} {'depart':>8} {'retry':>5}" if dynamic else ""
    print(f"{'id':>4} {'arrive':>8} {'b':>4} {'mode':>4} "
          f"{'admitted':>8} {'replan':>6} {'latency_ms':>11}{extra}  placement")
    for s in outcome.served:
        r = s.request
        lat = "-" if s.latency_s is None else f"{s.latency_s * 1e3:.2f}"
        place = "->".join(s.plan.placement) if (s.accepted and s.plan) else s.reason
        if dynamic:
            adm = "-" if s.admit_s is None else f"{s.admit_s:.3f}"
            dep = "-" if s.depart_s is None else f"{s.depart_s:.3f}"
            extra = f" {adm:>8} {dep:>8} {s.n_retries:>5}"
        print(f"{r.request_id:>4} {r.arrival_s:>8.3f} {r.batch_size:>4} "
              f"{r.mode:>4} {str(s.accepted):>8} {str(s.replanned):>6} "
              f"{lat:>11}{extra}  {place}")
    summary = outcome.summary()
    pct = {k: (f"{v * 1e3:.2f}ms" if v is not None else "-")
           for k, v in summary.items() if k.startswith("latency_p")}
    print(f"# accepted {outcome.n_accepted}/{outcome.n_requests} "
          f"(ratio {outcome.acceptance_ratio:.2f}), "
          f"{outcome.n_replanned} replanned, "
          f"p50/p95/p99 {pct['latency_p50_s']}/{pct['latency_p95_s']}/"
          f"{pct['latency_p99_s']}, {summary['wall_time_s']:.2f}s",
          file=sys.stderr)
    if dynamic:
        kind = "gateway" if args.gateway else "sim"
        print(f"# {kind}: horizon {outcome.horizon_s:.3f}s, "
              f"{outcome.n_departed} departed, "
              f"peak {outcome.peak_concurrent} concurrent, "
              f"{outcome.n_retried} admitted via retry, "
              f"blocking {outcome.blocking_probability:.2f}", file=sys.stderr)
    if failures is not None:
        fs = outcome.failure_summary()
        p95 = fs["restore_p95_s"]
        p95s = "-" if p95 is None else f"{p95:.3f}s"
        print(f"# failures: {len(failures)} events, "
              f"{fs['n_failed']} chains hit, {fs['n_restored']} restored, "
              f"{fs['n_killed']} killed, restore p95 {p95s}, "
              f"moved {fs['moved_bytes'] / 1e6:.1f} MB", file=sys.stderr)
    if args.gateway:
        gs = outcome.gateway_stats
        pc = gs.get("plan_cache", {})
        pct = gs["tick_wall_pct"]
        print(f"# gateway: {gs['n_ticks']} ticks "
              f"(window {args.batch_window_s}s), "
              f"tick p50/p95 {(pct['p50'] or 0.0) * 1e3:.2f}/"
              f"{(pct['p95'] or 0.0) * 1e3:.2f}ms, "
              f"max queue depth {gs['max_queue_depth']}, "
              f"{outcome.n_queue_rejected} queue-full, "
              f"{outcome.n_slo_rejected} slo-rejected, "
              f"plan-cache hit rate {pc.get('hit_rate', 0.0):.2f}, "
              f"{gs['admissions_per_s'] or 0.0:.1f} admissions/s",
              file=sys.stderr)
    if args.json:
        doc = {"summary": summary,
               "served": [s.to_dict() for s in outcome.served]}
        with open(args.json, "w") as fh:
            json.dump(doc, fh, indent=1)
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0 if outcome.n_accepted else 1


if __name__ == "__main__":
    sys.exit(main())
