PYTHON ?= python
export PYTHONPATH := src:$(PYTHONPATH)

.PHONY: verify verify-fast test test-fast sweep-quick bench-quick \
	bench-solver bench-solver-smoke bench-serve bench-serve-smoke \
	lint docs-check clean

## verify: repro-lint gate + tier-1 tests + one quick end-to-end sweep + the
## batched-solver and serving-gateway throughput smoke gates (the CI gate)
verify: lint test sweep-quick bench-solver-smoke bench-serve-smoke

## verify-fast: the core dev loop (<45s) — deselects the multi-minute
## jax-stack tests (pytest -m slow: shard_map subprocess runs, kernel
## sweeps, dry-runs) and runs quick serving sweeps: one static admission
## round, one event-driven churn suite (exercises the ServeSim loop), one
## failure-injection suite (exercises migration + trace replay), and one
## mixed training/inference suite (exercises the round-trip TR-pipe model
## and mode-split contention reporting, docs/training.md)
verify-fast: test-fast
	$(PYTHON) -m repro.sweep --suite nsfnet_multirequest nsfnet_churn \
		nsfnet_failures nsfnet_mixed_training --quick --out sweep_out

## test: tier-1 test suite (ROADMAP.md)
test:
	$(PYTHON) -m pytest -x -q

## test-fast: tier-1 suite without the slow-marked jax-stack tests
test-fast:
	$(PYTHON) -m pytest -x -q -m "not slow"

## sweep-quick: quick NSFNET paper-grid sweep through the scenario engine
sweep-quick:
	$(PYTHON) -m repro.sweep --suite nsfnet_paper --quick --out sweep_out

## bench-quick: all paper-figure benchmarks at the reduced CI tier
bench-quick:
	$(PYTHON) -m benchmarks.run --quick

## bench-solver: full solver-core throughput grid -> BENCH_solver.json
## (NumPy loop vs batched JAX vs Pallas, batch sizes 1..1024; exits non-zero
## unless warm batched JAX is >= 10x the NumPy loop at batch >= 256)
bench-solver:
	$(PYTHON) -m benchmarks.solver_throughput

## bench-solver-smoke: batch=8 gate only — warm batched JAX must beat the
## scalar NumPy loop
bench-solver-smoke:
	$(PYTHON) -m benchmarks.solver_throughput --smoke

## bench-serve: full gateway throughput grid (batch-window sweep, cold vs
## warm admissions/s, tick percentiles) -> BENCH_serve.json
bench-serve:
	$(PYTHON) -m benchmarks.serve_throughput

## bench-serve-smoke: one small streaming cell — warm sustained gateway
## throughput must clear the admissions/s floor (docs/gateway.md)
bench-serve-smoke:
	$(PYTHON) -m benchmarks.serve_throughput --smoke

## lint: repro-lint in --strict mode (docs/analysis.md), the JAX package's
## copy over src/repro and the port's over src/repro_torch (its baseline
## lint_baseline_torch.txt), + ruff's pyflakes tier over src/repro as the
## generic complement where installed (CI installs it; local trees without
## ruff still get the full repro-lint gate)
lint:
	$(PYTHON) -m repro.analysis --strict src/repro
	$(PYTHON) -m repro_torch.analysis --strict src/repro_torch
	@if command -v ruff > /dev/null 2>&1; then \
		ruff check src/repro; \
	else \
		echo "ruff not installed; skipped the generic pyflakes tier"; \
	fi

## docs-check: CLIs import/--help cleanly and docs/*.md links are unbroken
docs-check:
	$(PYTHON) -m repro.sweep --help > /dev/null
	$(PYTHON) -m repro.serve --help > /dev/null
	$(PYTHON) -m repro.serve --gateway --n-requests 4 --arrival poisson \
		--batch-window-s 0.5 > /dev/null
	$(PYTHON) scripts/check_docs_sync.py

clean:
	rm -rf sweep_out .pytest_cache
	find . -name __pycache__ -type d -prune -exec rm -rf {} +
