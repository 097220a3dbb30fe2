"""CLI for the scenario-sweep engine.

    PYTHONPATH=src python -m repro_torch.sweep --suite nsfnet_paper --quick
    PYTHONPATH=src python -m repro_torch.sweep --list
    PYTHONPATH=src python -m repro_torch.sweep --list-solvers
    PYTHONPATH=src python -m repro_torch.sweep --suite nsfnet_faults \
        --workers 2 --out sweep_out --cache-dir sweep_out/.cache
    PYTHONPATH=src python -m repro_torch.sweep --suite nsfnet_paper --quick \
        --device cpu

``--device`` is where the solvers that take one (``bcd_torch``,
``dfts_torch``) run, ``cuda`` by default; without a card the CLI exits 2
unless ``--device cpu`` is given.

Artifacts land in ``--out`` (default ``sweep_out/``): ``<suite>.json`` with
per-scenario latency breakdowns + the comparison/Pareto report, and a flat
``<suite>.csv``.  With a cache dir (default ``<out>/.cache``) a re-run of the
same suite is served from disk and reports its cache-hit count.
"""
from __future__ import annotations

import argparse
import sys
import time

from .artifacts import write_artifacts
from .report import comparison_report, format_report
from .runner import SweepRunner
from .suites import SUITES


def _workers_arg(value: str) -> int | None:
    """'auto' -> None (all cores); otherwise an int (see SweepRunner.resolve_workers)."""
    if value == "auto":
        return None
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {value!r}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep",
                                 description="scenario-sweep engine")
    ap.add_argument("--suite", nargs="*", default=None,
                    help=f"suites to run (default: nsfnet_paper); have {list(SUITES)}")
    ap.add_argument("--quick", action="store_true", help="reduced grids (CI tier)")
    ap.add_argument("--out", default="sweep_out", help="artifact directory")
    ap.add_argument("--cache-dir", default=None,
                    help="result cache dir (default <out>/.cache)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the on-disk result cache")
    ap.add_argument("--workers", type=_workers_arg, default=0,
                    help="worker processes: 0 or 1 = serial in-process "
                         "(default), N >= 2 = N processes, 'auto' or a "
                         "negative value = all cores (os.cpu_count())")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the solvers that take one (bcd_torch, "
                         "dfts_torch); cuda by default")
    ap.add_argument("--list", action="store_true", help="list suites and exit")
    ap.add_argument("--list-solvers", action="store_true",
                    help="list registered solvers + declared capabilities "
                         "and exit")
    args = ap.parse_args(argv)

    if args.list_solvers:
        from ..core.engine import solver_capabilities

        print(f"{'solver':<12} {'schedules':<10} {'optimal':>7} {'meta':>5}  "
              f"description")
        for cap in solver_capabilities():
            print(f"{cap['name']:<12} {'+'.join(cap['schedules']):<10} "
                  f"{str(cap['optimal']):>7} {str(cap['meta']):>5}  "
                  f"{cap['description']}")
        return 0

    if args.list:
        for name, fn in SUITES.items():
            n_quick, n_full = len(fn(quick=True)), len(fn(quick=False))
            print(f"{name:<16} quick={n_quick:>4} scenarios, full={n_full:>5}")
        return 0

    names = args.suite or ["nsfnet_paper"]
    unknown = [n for n in names if n not in SUITES]
    if unknown:
        print(f"unknown suite(s) {unknown}; have {list(SUITES)}", file=sys.stderr)
        return 2

    cache_dir = None if args.no_cache else (args.cache_dir or f"{args.out}/.cache")
    try:
        runner = SweepRunner(cache_dir=cache_dir, workers=args.workers,
                             device=args.device)
    except RuntimeError as exc:
        ap.error(f"{exc} (--device cpu)")
    rc = 0
    for name in names:
        specs = SUITES[name](quick=args.quick)
        print(f"# suite {name}: {len(specs)} scenarios "
              f"(quick={args.quick}, workers={runner.workers})", file=sys.stderr)
        t0 = time.perf_counter()
        results = runner.run(specs)
        wall = time.perf_counter() - t0
        st = runner.last_stats
        paths = write_artifacts(args.out, name, results,
                                meta={"quick": args.quick, "stats": st})
        n_feas = sum(r.feasible for r in results)
        print(f"# {name}: {n_feas}/{len(results)} feasible, "
              f"{st['n_cache_hits']} cache hits, {st['n_solved']} solved, "
              f"{wall:.2f}s", file=sys.stderr)
        print(format_report(comparison_report(results)))
        print(f"# artifacts: {paths['json']} {paths['csv']}", file=sys.stderr)
        if n_feas == 0:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
