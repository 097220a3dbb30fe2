"""The port's repro-lint (``repro_torch.analysis``) held to the JAX
package's (``repro.analysis``) on the CPU.

Every test of ``tests/test_analysis.py`` that writes a fixture project runs
once more with that module's entry points rebound to the port's copy
(``run_analysis``, the baseline file's functions, the CLI), and each
project it wrote then goes through both packages with every rule: the same
findings, rule, path, line, message and fix.  The port's tree gives both
packages the same findings before baselines and lints clean under
``lint_baseline_torch.txt``; the rules engage on it.  The one stated
difference is the determinism rule's reach over torch's global RNG stream,
which only the port's copy flags.
"""
from __future__ import annotations

import inspect
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as REF
import repro_torch.analysis as PORT
import test_analysis as REF_TESTS
from repro_torch.analysis import cli as port_cli

REPO = Path(__file__).resolve().parent.parent
PORT_TREE = REPO / "src" / "repro_torch"

# the reference's tests of a fixture project (a tmp_path argument) and of
# the CLI's catalog; its whole-repo tests check src/repro and have their
# port counterparts below
REPO_WIDE = ("test_whole_repo", "test_docs_sync")
FIXTURE_TESTS = [name for name, fn in vars(REF_TESTS).items()
                 if name.startswith("test_") and callable(fn)
                 and not name.startswith(REPO_WIDE)
                 and set(inspect.signature(fn).parameters) <= {"tmp_path",
                                                                 "capsys"}]


def _rows(findings) -> list[tuple]:
    return [(f.rule, f.path, f.line, f.col, f.message, f.suggestion)
            for f in findings]


def _both(paths, root, select=None) -> tuple[list, list]:
    return (_rows(REF.run_analysis(paths, root, select=select)),
            _rows(PORT.run_analysis(paths, root, select=select)))


@pytest.mark.parametrize("name", FIXTURE_TESTS)
def test_reference_fixture_holds_for_the_port(name, tmp_path, capsys,
                                              monkeypatch):
    """The reference's test passes with the port's copy in its place, and
    every project it wrote gives both packages the same findings."""
    projects = []
    write = REF_TESTS.write_project

    def recording(tmp, files):
        root = write(tmp, files)
        projects.append(root)
        return root

    monkeypatch.setattr(REF_TESTS, "write_project", recording)
    for attr in ("Finding", "run_analysis", "load_baseline",
                 "save_baseline"):
        monkeypatch.setattr(REF_TESTS, attr, getattr(PORT, attr))
    monkeypatch.setattr(REF_TESTS, "cli_main", port_cli.main)
    fn = getattr(REF_TESTS, name)
    fn(**{k: {"tmp_path": tmp_path, "capsys": capsys}[k]
          for k in inspect.signature(fn).parameters})
    for root in projects:  # none for the baseline file's and catalog's
        ref, port = _both([root], root)
        assert port == ref


def test_the_fixture_tests_are_all_taken():
    # a new fixture test of tests/test_analysis.py joins the list above
    assert len(FIXTURE_TESTS) >= 28
    assert {"test_cache_key_arity_collision_across_files",
            "test_registry_transitive_handling_through_import",
            "test_spec_hash_stale_allowlist_entry",
            "test_shim_import_flagged", "test_parse_error_is_a_finding",
            "test_baseline_roundtrip_suppresses_and_catches_new",
            "test_cli_exit_codes", "test_cli_list_rules"} <= set(
        FIXTURE_TESTS)


# ----------------------------------------------------------- the port's tree
def test_both_packages_agree_on_the_port_tree():
    """Before baselines, rule by rule: the one finding is the provenance
    timestamp that lint_baseline_torch.txt accepts with its reason;
    docs-sync, each copy over its own list, finds nothing."""
    ref, port = _both([PORT_TREE], REPO)
    for rule in PORT.rule_names():
        assert [r for r in port if r[0] == rule] == \
            [r for r in ref if r[0] == rule], rule
    assert port == ref
    assert [(r[0], r[1], r[4]) for r in port] == [
        ("determinism", "src/repro_torch/sweep/artifacts.py",
         "wall-clock call time.time() in deterministic path")]
    baseline = PORT.load_baseline(REPO / "lint_baseline_torch.txt")
    assert len(baseline) == 1
    kept, suppressed, stale = baseline.apply(
        PORT.run_analysis([PORT_TREE], REPO))
    assert kept == [] and len(suppressed) == 1 and stale == []
    reason = next(iter(baseline.entries.values()))
    assert any("provenance timestamp" in line for line in reason)


def test_port_tree_strict_clean_under_its_baseline():
    """``python -m repro_torch.analysis --strict src/repro_torch``, as the
    Makefile's lint target and the smoke's lint phase run it."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict",
         "src/repro_torch"], cwd=REPO, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
    assert "1 baseline-suppressed" in proc.stdout


def test_default_path_and_baseline_are_the_ports(tmp_path, capsys):
    assert port_cli.main(["--root", str(REPO), "--strict"]) == 0
    assert "file(s), 1 baseline-suppressed" in capsys.readouterr().out
    # the reference's baseline lists src/repro paths: under it the port's
    # finding is kept
    assert port_cli.main(["--baseline", str(REPO / "lint_baseline.txt"),
                          str(PORT_TREE)]) == 1


def test_rules_engage_on_the_port_tree():
    from repro_torch.analysis.base import collect_modules
    from repro_torch.analysis.rules_cache import (_eval_sites,
                                                  _plancache_sites)
    from repro_torch.analysis.rules_registry import _registrations

    ctx = collect_modules([PORT_TREE], REPO)
    n_eval = sum(len(list(_eval_sites(m.tree))) for m in ctx.modules)
    n_pc = sum(len(list(_plancache_sites(m.tree))) for m in ctx.modules)
    assert n_eval >= 6 and n_pc >= 2
    declared = {fn.name: d for _, fn, _, d in _registrations(ctx)}
    for name in ("dfts_torch_solve", "bcd_torch_solve", "exact_solve",
                 "ilp_solve"):
        assert declared.get(name) is not None, name
    assert declared["bcd_torch_solve"] == {"seq", "pipe"}
    assert declared["dfts_torch_solve"] == {"seq", "pipe"}


# a bcd_torch-like solver registered in the call form, as the port's is
BCD_TORCH_LIKE = """
    def bcd_torch_solve(net, profile, request, K, candidates,
                        device="cuda"):
        pipelined = request.schedule == PIPE and request.microbatches() > 1
        segments = even_split(profile, K)
        return dfts_torch_plan(net, profile, request, segments, candidates,
                               pipelined=pipelined, device=device)

    register_solver("bcd_torch", schedules=(SEQ, PIPE),
                    batch=None)(bcd_torch_solve)
"""


@pytest.mark.parametrize("drift", [False, True], ids=["kept", "drifted"])
def test_seeded_registry_drift(tmp_path, drift):
    """A bcd_torch that declares PIPE and never branches on it gives
    ``solver-registry`` in both copies; with its branch, neither does."""
    body = BCD_TORCH_LIKE
    if drift:
        body = body.replace(
            "pipelined = request.schedule == PIPE and "
            "request.microbatches() > 1", "pipelined = False")
    root = REF_TESTS.write_project(tmp_path, {
        "core/torch_solvers.py": REF_TESTS.solver_module(body)})
    ref, port = _both([root], root, select=["solver-registry"])
    assert port == ref
    assert len(port) == int(drift)
    if drift:
        assert "solver 'bcd_torch_solve' declares schedule 'pipe'" in \
            port[0][4]


# ------------------------------------- the determinism rule's torch reach
TORCH_SAMPLES = ["torch.rand(3)", "torch.randn(2, 3)",
                 "torch.randint(0, 5, (3,))", "torch.randperm(4)",
                 "torch.normal(0.0, 1.0, (3,))", "torch.bernoulli(p)",
                 "torch.multinomial(p, 1)", "torch.poisson(p)",
                 "torch.rand_like(p)", "torch.randn_like(p)",
                 "torch.randint_like(p, 5)", "p.normal_()", "p.uniform_()",
                 "p.random_()", "p.exponential_()", "p.bernoulli_()",
                 "p.geometric_(0.5)", "p.log_normal_()", "p.cauchy_()",
                 "torch.empty(3).normal_(0.0, 1.0)"]
TORCH_RESEEDS = ["torch.manual_seed(0)", "torch.seed()",
                 "torch.random.manual_seed(0)", "torch.random.seed()",
                 "torch.cuda.manual_seed(0)", "torch.cuda.manual_seed_all(0)",
                 "torch.cuda.seed()", "torch.cuda.seed_all()"]


def _rng_module(call: str, tail: str = "") -> str:
    return textwrap.dedent(f"""
        import torch


        def draw(p):
            return {call}{tail}
    """)


def _determinism(tmp_path, rel: str, text: str) -> tuple[list, list]:
    root = REF_TESTS.write_project(tmp_path, {rel: text})
    return _both([root], root, select=["determinism"])


@pytest.mark.parametrize("call", TORCH_SAMPLES + TORCH_RESEEDS)
def test_torch_global_stream_is_flagged_by_the_port_only(tmp_path, call):
    """Each form in ``core/`` is one finding of the port's copy (the
    reference's sees none); ``# noqa`` suppresses it and ``launch/`` is
    allowlisted."""
    ref, port = _determinism(tmp_path / "core", "core/x.py",
                             _rng_module(call))
    assert ref == []
    assert len(port) == 1 and port[0][0] == "determinism"
    assert port[0][4].startswith("global-stream RNG call ")
    assert "torch.Generator(device).manual_seed(seed)" in port[0][5]
    for rel, tail in (("core/x.py", "  # noqa: seeded by the caller"),
                      ("launch/x.py", "")):
        ref, port = _determinism(tmp_path / rel.replace("/", "_"), rel,
                                 _rng_module(call, tail))
        assert ref == [] and port == [], rel


@pytest.mark.parametrize("call", TORCH_SAMPLES)
def test_torch_samplers_with_a_generator_pass(tmp_path, call):
    seeded = call[:-1] + (", " if not call.endswith("()") else "") + \
        "generator=gen)"
    ref, port = _determinism(tmp_path, "sweep/x.py", _rng_module(seeded))
    assert ref == [] and port == []


def test_port_idiom_passes(tmp_path):
    """The port's own idiom: a generator seeded and threaded through."""
    ref, port = _determinism(tmp_path, "msl/x.py", textwrap.dedent("""
        import torch


        def init(seed, device):
            gen = torch.Generator(device=device).manual_seed(seed)
            w = torch.randn(4, 4, generator=gen)
            return w.normal_(0.0, 1.0, generator=gen), gen.seed
    """))
    assert ref == [] and port == []
