"""Named scenario suites — the registry every benchmark and the CLI draw from.

Each suite function returns ``list[ScenarioSpec]`` and takes ``quick`` (reduced
grids for CI) plus optional keyword filters so the benchmark drivers can slice
a suite (e.g. one mode of the NSFNET paper grid).

The suites are the JAX package's, with one renaming: wherever that package
sweeps the paper's BCD scheme as ``"bcd"``, these name :data:`BCD`,
``bcd_torch``, the same algorithm with its DP scans on the runner's device
and bit-identical plans.  So a sweep reaches the card through
``SweepRunner``'s batched presolve.  ``exact``, ``ilp``, ``comp-ms``,
``comm-ms`` and ``portfolio`` stay host solvers.
"""
from __future__ import annotations

from ..core import IF, TR

from .spec import ScenarioSpec, candidate_sets

# The paper's NSFNET node ordering (v1..v14) — candidate sampling is seeded, so
# the ordering is part of the reproducible scenario definition.
NSFNET_NODES = [f"v{i}" for i in range(1, 15)]
SOURCE, DEST = "v4", "v13"

# `exact` is the ILP-equivalent joint DP (tests prove equality with the HiGHS
# MILP); the latency grids use it so the full paper sweep stays fast.  `ilp`
# is reserved for the exec-time suites, where its wall time is the measurement.
# `portfolio` is the engine's best-of-heuristics meta-solver (docs/solvers.md);
# sweeping it alongside its members shows the best-of gap vs the optimum.
# The BCD scheme of every suite: the JAX package's "bcd" on the device.
BCD = "bcd_torch"
LATENCY_SCHEMES = ("exact", BCD, "comp-ms", "comm-ms", "portfolio")
EXEC_SCHEMES = ("ilp", BCD, "comp-ms", "comm-ms")


def _nsfnet_spec(mode: str, K: int, b: int, solver: str, seed: int,
                 tags: dict, **overrides) -> ScenarioSpec:
    cands = candidate_sets(K, seed, NSFNET_NODES, SOURCE, DEST)
    return ScenarioSpec(
        topology="nsfnet", topology_kwargs={"source": SOURCE},
        profile="resnet101", source=SOURCE, destination=DEST,
        batch_size=b, mode=mode, K=K, solver=solver,
        candidates=cands, candidate_seed=seed,
        tags={"suite": "nsfnet_paper", "seed": seed, **tags},
        **overrides,
    )


def nsfnet_paper(quick: bool = False, modes: tuple[str, ...] = (IF, TR),
                 seeds: int = 10,
                 schemes: tuple[str, ...] = LATENCY_SCHEMES) -> list[ScenarioSpec]:
    """Figs. 4 & 5 grid: latency vs (K, b) per scheme, averaged over seeds."""
    ks = [2, 3, 5] if quick else list(range(2, 8))
    bs = [2, 128] if quick else [2**i for i in range(0, 9)]
    n_seeds = 3 if quick else seeds
    specs = []
    for mode in modes:
        fig = "fig4" if mode == IF else "fig5"
        for K in ks:
            for b in bs:
                for solver in schemes:
                    for seed in range(n_seeds):
                        specs.append(_nsfnet_spec(
                            mode, K, b, solver, seed,
                            {"figure": fig, "cell": f"K{K}_b{b}"}))
    return specs


def exec_time_k(quick: bool = False,
                ilp_time_limit_s: float = 120.0) -> list[ScenarioSpec]:
    """Fig. 10: solver wall time vs chain length K (training, b=128)."""
    ks = [2, 4] if quick else list(range(2, 8))
    specs = []
    for K in ks:
        n_seeds = 1 if (quick or K >= 6) else 3  # big-K MILPs are slow (1 core)
        for solver in EXEC_SCHEMES:
            for seed in range(n_seeds):
                kw = {"time_limit_s": ilp_time_limit_s} if solver == "ilp" else {}
                specs.append(_nsfnet_spec(
                    TR, K, 128, solver, seed,
                    {"suite": "exec_time_k", "figure": "fig10", "cell": f"K{K}"},
                    solver_kwargs=kw))
    return specs


def random_scaling(quick: bool = False,
                   ilp_time_limit_s: float = 120.0) -> list[ScenarioSpec]:
    """Fig. 11 scaling ladder: random G(V, p=0.2) networks, K=4, training."""
    vs = [10, 20] if quick else [10, 20, 30, 40, 50]
    specs = []
    for V in vs:
        nodes = sorted(f"v{i}" for i in range(1, V + 1))
        dest = nodes[-1]
        for solver in EXEC_SCHEMES:
            if solver == "ilp" and V >= 30 and quick:
                continue
            cands = candidate_sets(4, 0, nodes, "v1", dest)
            kw = {"time_limit_s": ilp_time_limit_s} if solver == "ilp" else {}
            specs.append(ScenarioSpec(
                topology="random",
                topology_kwargs={"n_nodes": V, "p": 0.2, "seed": 7,
                                 "source": "v1"},
                profile="resnet101", source="v1", destination=dest,
                batch_size=128, mode=TR, K=4, solver=solver,
                solver_kwargs=kw, candidates=cands,
                tags={"suite": "random_scaling", "figure": "fig11",
                      "cell": f"V{V}"}))
    return specs


def tpu_pod(quick: bool = False) -> list[ScenarioSpec]:
    """TPU-pod graphs: pattern-group profiles planned over ICI/DCN topologies."""
    grids = ([("qwen2-1.5b", 8, 16, 1)] if quick
             else [("qwen2-1.5b", 8, 16, 1), ("qwen2-1.5b", 16, 16, 2),
                   ("qwen3-14b", 8, 32, 1)])
    ks = [2, 4]
    specs = []
    for arch, n_groups, chips, n_pods in grids:
        nodes = sorted(f"p{p}g{g}" for p in range(n_pods) for g in range(n_groups))
        for K in ks:
            for mode, b in ((TR, 8), (IF, 32)):
                for solver in ("exact", BCD):
                    specs.append(ScenarioSpec(
                        topology="tpu_pod",
                        topology_kwargs={"n_groups": n_groups,
                                         "chips_per_group": chips,
                                         "n_pods": n_pods},
                        profile="group",
                        profile_kwargs={"arch": arch, "seq_len": 2048,
                                        "mode": "train" if mode == TR else "prefill"},
                        source=nodes[0], destination=nodes[-1],
                        batch_size=b, mode=mode, K=K, solver=solver,
                        tags={"suite": "tpu_pod", "arch": arch,
                              "cell": f"{arch}_g{n_groups}x{chips}_K{K}_{mode}"}))
    return specs


def nsfnet_faults(quick: bool = False) -> list[ScenarioSpec]:
    """Fault-injected NSFNET variants: kill a transit node or trunk link and
    compare how BCD re-plans against the optimum on the degraded fabric."""
    faults = [
        ("baseline", [], []),
        ("node_v7_down", ["v7"], []),
        ("node_v9_down", ["v9"], []),
        ("link_v4_v5_down", [], [["v4", "v5"]]),
        ("links_v6_down", [], [["v6", "v10"], ["v6", "v13"]]),
    ]
    if quick:
        faults = faults[:3]
    specs = []
    for fname, drop_nodes, drop_links in faults:
        alive = [n for n in NSFNET_NODES if n not in drop_nodes]
        for seed in range(1 if quick else 3):
            cands = candidate_sets(3, seed, alive, SOURCE, DEST)
            for solver in ("exact", BCD):
                for mode, b in ((IF, 2), (TR, 128)):
                    specs.append(ScenarioSpec(
                        topology="nsfnet", topology_kwargs={"source": SOURCE},
                        drop_nodes=list(drop_nodes), drop_links=drop_links,
                        profile="resnet101", source=SOURCE, destination=DEST,
                        batch_size=b, mode=mode, K=3, solver=solver,
                        candidates=cands, candidate_seed=seed,
                        tags={"suite": "nsfnet_faults", "fault": fname,
                              "cell": f"{fname}_{mode}_b{b}", "seed": seed}))
    return specs


def nsfnet_pipeline(quick: bool = False,
                    microbatches: tuple[int, ...] | None = None,
                    schemes: tuple[str, ...] = (BCD,)) -> list[ScenarioSpec]:
    """Seq-vs-pipe grid on NSFNET: every cell is solved once under the paper's
    sequential schedule and once per pipeline depth M (docs/pipeline.md).

    Pipe scenarios use BCD (schedule-aware, seq-anchored, so pipe <= seq per
    pair by construction); the seq side additionally runs ``exact`` as the
    optimality reference.  The report's ``schedule_comparison`` section and the
    CSV's ``seq_latency_s`` / ``pipe_speedup`` columns come from this pairing.
    The exact pipelined joint DP is a small-instance parity oracle (its
    bottleneck-cap scan multiplies the DP cost), so it is deliberately not
    swept here.
    """
    if microbatches is None:
        microbatches = (1, 4, 16) if quick else (1, 2, 4, 8, 16, 32)
    ks = [3] if quick else [3, 5]
    cells = [(IF, 32), (TR, 128)]
    seeds = 1 if quick else 3
    specs = []
    for K in ks:
        for mode, b in cells:
            for seed in range(seeds):
                tags = {"suite": "nsfnet_pipeline",
                        "cell": f"K{K}_b{b}_{mode}", "seed": seed}
                for solver in dict.fromkeys(("exact",) + tuple(schemes)):
                    specs.append(_nsfnet_spec(mode, K, b, solver, seed, tags))
                for solver in schemes:
                    for M in microbatches:
                        specs.append(_nsfnet_spec(
                            mode, K, b, solver, seed, tags,
                            schedule="pipe", n_microbatches=M))
    return specs


def nsfnet_multirequest(quick: bool = False,
                        policies: tuple[str, ...] = ("fcfs", "latency-greedy",
                                                     "batch-desc"),
                        schemes: tuple[str, ...] = ("exact", BCD)
                        ) -> list[ScenarioSpec]:
    """Concurrent serving on NSFNET: fleets of chains (batch spread x1/x2/x4)
    admitted onto one fabric with residual-capacity accounting.  Groups share
    everything but the solver, so the report compares BCD's acceptance ratio
    against the exact replanner's under identical policies and load."""
    fleets = [4, 16] if quick else [2, 4, 8, 16, 32]
    seeds = 1 if quick else 3
    specs = []
    for n in fleets:
        for policy in policies:
            for solver in schemes:
                for seed in range(seeds):
                    specs.append(ScenarioSpec(
                        topology="nsfnet", topology_kwargs={"source": SOURCE},
                        profile="resnet101", source=SOURCE, destination=DEST,
                        batch_size=2, mode=IF, K=3, solver=solver,
                        candidate_seed=seed,
                        n_requests=n, arrival="batch", policy=policy,
                        tags={"suite": "nsfnet_multirequest", "seed": seed,
                              "cell": f"n{n}_{policy}"}))
    return specs


def nsfnet_churn(quick: bool = False,
                 policies: tuple[str, ...] = ("fcfs",),
                 schemes: tuple[str, ...] = (BCD,),
                 hold_s: float = 4.0) -> list[ScenarioSpec]:
    """Dynamic admission under churn vs the static snapshot round
    (docs/sim.md): every cell is one Poisson fleet admitted twice — once as
    today's one-shot `ServePlanner.admit` (every accepted chain holds its
    reservation forever) and once through the event-driven `ServeSim` with
    Exponential(mean `hold_s`) holding times and the retry queue.  Both
    variants share the *identical* fleet (holding times come from a dedicated
    seeded stream), pair on ``ScenarioSpec.churn_key()``, and feed the
    report's ``churn_comparison`` section: on overloaded cells the churn
    acceptance is strictly higher, because capacity released by departures is
    re-used — the regime the ROADMAP's "heavy traffic" north star needs."""
    fleets = [16, 32] if quick else [8, 16, 32, 64]
    seeds = 1 if quick else 3
    specs = []
    for n in fleets:
        for policy in policies:
            for solver in schemes:
                for seed in range(seeds):
                    base = dict(
                        topology="nsfnet", topology_kwargs={"source": SOURCE},
                        profile="resnet101", source=SOURCE, destination=DEST,
                        batch_size=2, mode=IF, K=3, solver=solver,
                        candidate_seed=seed, n_requests=n, arrival="poisson",
                        policy=policy)
                    tags = {"suite": "nsfnet_churn", "seed": seed,
                            "cell": f"n{n}_{policy}"}
                    specs.append(ScenarioSpec(
                        **base, tags={**tags, "variant": "static"}))
                    specs.append(ScenarioSpec(
                        **base, sim=True, hold_model="exp", duration_s=hold_s,
                        retry=True, tags={**tags, "variant": "churn"}))
    return specs


def nsfnet_failures(quick: bool = False,
                    policies: tuple[str, ...] = ("fcfs",),
                    schemes: tuple[str, ...] = (BCD,),
                    hold_s: float = 6.0,
                    failure_rates: tuple[float, ...] | None = None
                    ) -> list[ScenarioSpec]:
    """Survivability under substrate failures (docs/failures.md): every cell
    is one Poisson churn fleet admitted at several failure rates — the
    ``rate 0`` anchor is bit-for-bit the plain churn run (``failures`` stays
    None, so the failure-free code path is exercised, not just skipped) —
    plus an HA variant at the highest rate, where each chain pre-plans a
    disjoint standby promoted on failure.  Failed resources recover after
    Exponential(mean ``2 * hold_s``) downtime, so the curves show both the
    migration transient and the post-recovery steady state; the report's
    ``failure_survivability`` section and the CSV's ``n_failed`` /
    ``n_restored`` / ``restore_p95_s`` / ``moved_bytes`` columns come from
    this suite."""
    if failure_rates is None:
        failure_rates = (0.0, 0.2) if quick else (0.0, 0.1, 0.2, 0.4)
    fleets = [16] if quick else [16, 32, 64]
    seeds = 1 if quick else 3
    specs = []
    for n in fleets:
        for policy in policies:
            for solver in schemes:
                for seed in range(seeds):
                    base = dict(
                        topology="nsfnet", topology_kwargs={"source": SOURCE},
                        profile="resnet101", source=SOURCE, destination=DEST,
                        batch_size=2, mode=IF, K=3, solver=solver,
                        candidate_seed=seed, n_requests=n, arrival="poisson",
                        policy=policy, sim=True, hold_model="exp",
                        duration_s=hold_s, retry=True)
                    tags = {"suite": "nsfnet_failures", "seed": seed,
                            "cell": f"n{n}_{policy}"}
                    for rate in failure_rates:
                        specs.append(ScenarioSpec(
                            **base, failure_rate=rate,
                            failure_downtime_s=(2 * hold_s if rate else None),
                            tags={**tags, "variant": f"rate{rate}",
                                  "failure_rate": rate}))
                    specs.append(ScenarioSpec(
                        **base, failure_rate=failure_rates[-1],
                        failure_downtime_s=2 * hold_s, ha=True,
                        tags={**tags, "variant": "ha",
                              "failure_rate": failure_rates[-1]}))
    return specs


def nsfnet_gateway(quick: bool = False,
                   policies: tuple[str, ...] = ("fcfs",),
                   schemes: tuple[str, ...] = (BCD,),
                   hold_s: float = 4.0,
                   windows: tuple[float, ...] | None = None
                   ) -> list[ScenarioSpec]:
    """Streaming admission through the `ServeGateway` (docs/gateway.md):
    every cell is one Poisson fleet admitted twice — once as the static
    one-shot round and once streamed through the gateway with
    Exponential(mean `hold_s`) holding times, the retry queue, and a swept
    arrival batching window.  Variants share the identical fleet and pair on
    ``ScenarioSpec.churn_key()``; the gateway rows additionally surface the
    plan-cache / eval-cache hit rates and per-tick stats in the artifact."""
    if windows is None:
        windows = (0.0, 0.5) if quick else (0.0, 0.25, 0.5, 1.0)
    fleets = [16, 32] if quick else [8, 16, 32, 64]
    seeds = 1 if quick else 3
    specs = []
    for n in fleets:
        for policy in policies:
            for solver in schemes:
                for seed in range(seeds):
                    base = dict(
                        topology="nsfnet", topology_kwargs={"source": SOURCE},
                        profile="resnet101", source=SOURCE, destination=DEST,
                        batch_size=2, mode=IF, K=3, solver=solver,
                        candidate_seed=seed, n_requests=n, arrival="poisson",
                        policy=policy)
                    tags = {"suite": "nsfnet_gateway", "seed": seed,
                            "cell": f"n{n}_{policy}"}
                    specs.append(ScenarioSpec(
                        **base, tags={**tags, "variant": "static"}))
                    for w in windows:
                        specs.append(ScenarioSpec(
                            **base, gateway=True, batch_window_s=w,
                            hold_model="exp", duration_s=hold_s, retry=True,
                            tags={**tags, "variant": "gateway",
                                  "window": w}))
    return specs


def nsfnet_mixed_training(quick: bool = False,
                          shares: tuple[float, ...] | None = None,
                          archs: tuple[tuple[str, dict], ...] | None = None,
                          policies: tuple[str, ...] = ("fcfs",),
                          schemes: tuple[str, ...] = (BCD,),
                          n_microbatches: int = 4) -> list[ScenarioSpec]:
    """Mixed training/inference fleets on NSFNET (docs/training.md): every
    cell is one Poisson fleet admitted at several ``train_share`` values —
    each request is drawn TR (a round-trip pipelined training chain whose
    gradients occupy the links' backward channels) or IF from a dedicated
    seeded stream, so the ``share 0`` anchor is bit-for-bit the all-IF fleet
    and every mixed variant sees identical arrivals/candidates, pairing on
    ``ScenarioSpec.training_key()``.  Fleets are heterogeneous across the
    model zoo: the paper's ResNet101 profile plus pattern-group train-mode
    profiles of the assigned architectures that *fit* NSFNET's 2 GiB edge
    nodes (the SSM and encoder-decoder members; the multi-GB LLMs belong to
    the ``tpu_pod`` suite).  All chains run the pipelined schedule
    (M = ``n_microbatches``), so TR admissions price the two-bottleneck round
    trip — the report's ``training_contention`` section and the CSV's
    mode-split columns come from this suite."""
    if shares is None:
        shares = (0.0, 0.5) if quick else (0.0, 0.25, 0.5, 0.75)
    if archs is None:
        zoo = [("mamba2-370m", 256)] if quick else [
            ("mamba2-370m", 1024), ("whisper-small", 1500)]
        archs = (("resnet101", {}),) + tuple(
            ("group", {"arch": a, "seq_len": s, "mode": "train"})
            for a, s in zoo)
    fleets = [8] if quick else [8, 16, 32]
    seeds = 1 if quick else 3
    specs = []
    for profile, prof_kwargs in archs:
        label = prof_kwargs.get("arch", profile)
        for n in fleets:
            for policy in policies:
                for solver in schemes:
                    for seed in range(seeds):
                        for share in shares:
                            specs.append(ScenarioSpec(
                                topology="nsfnet",
                                topology_kwargs={"source": SOURCE},
                                profile=profile, profile_kwargs=prof_kwargs,
                                source=SOURCE, destination=DEST,
                                batch_size=2, mode=IF, K=3, solver=solver,
                                candidate_seed=seed, n_requests=n,
                                arrival="poisson", policy=policy,
                                schedule="pipe",
                                n_microbatches=n_microbatches,
                                train_share=share,
                                tags={"suite": "nsfnet_mixed_training",
                                      "seed": seed, "arch": label,
                                      "cell": f"{label}_n{n}_{policy}",
                                      "train_share": share}))
    return specs


def random_load_scaling(quick: bool = False,
                        policies: tuple[str, ...] = ("fcfs", "latency-greedy")
                        ) -> list[ScenarioSpec]:
    """Load ladder on random G(V, p=0.2) fabrics: growing Poisson fleets of
    training chains, acceptance ratio and latency percentiles vs load."""
    vs = [10, 20] if quick else [10, 20, 30, 40]
    loads = [8, 32] if quick else [8, 16, 32, 64]
    specs = []
    for V in vs:
        dest = sorted(f"v{i}" for i in range(1, V + 1))[-1]
        for n in loads:
            for policy in policies:
                specs.append(ScenarioSpec(
                    topology="random",
                    topology_kwargs={"n_nodes": V, "p": 0.2, "seed": 7,
                                     "source": "v1"},
                    profile="resnet101", source="v1", destination=dest,
                    batch_size=2, mode=TR, K=4, solver=BCD,
                    n_requests=n, arrival="poisson", policy=policy,
                    tags={"suite": "random_load_scaling",
                          "cell": f"V{V}_n{n}_{policy}"}))
    return specs


SUITES = {
    "nsfnet_paper": nsfnet_paper,
    "exec_time_k": exec_time_k,
    "random_scaling": random_scaling,
    "tpu_pod": tpu_pod,
    "nsfnet_faults": nsfnet_faults,
    "nsfnet_pipeline": nsfnet_pipeline,
    "nsfnet_multirequest": nsfnet_multirequest,
    "nsfnet_churn": nsfnet_churn,
    "nsfnet_failures": nsfnet_failures,
    "nsfnet_gateway": nsfnet_gateway,
    "nsfnet_mixed_training": nsfnet_mixed_training,
    "random_load_scaling": random_load_scaling,
}
