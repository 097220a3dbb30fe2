"""Core of the port: joint model splitting, placement and chaining for
SFC-based multi-hop split learning/inference, solved on the card.

The solving API is the engine triple of the JAX package's ``repro.core``:

  * `ProblemInstance` -- frozen, content-hashable problem description
    (network + profile + request + K + candidate sets);
    `ProblemInstance.from_content_key` rebuilds one from the JAX package's
    canonical key.
  * `solve(problem, solver=...)` / `solve_batch(problems, solver=...)` --
    capability-checked dispatch through the solver registry; returns
    `SolveOutcome`s.
  * `@register_solver(name, schedules=..., optimal=...)`.

Registered solvers:
  * `dfts_torch` -- even split + one DFTS tour, batched; the tours of all
                    instances run in lockstep waves, each wave's min-plus
                    DP on ``device`` (default ``"cuda"``) through the CUDA
                    fused scan kernel.  Bit-identical to `dfts_np`.
  * `bcd_torch`  -- the paper's BCD heuristic (Alg. 1) with both blocks on
                    ``device``.  Bit-identical to `bcd`.
  * `dfts_np`, `bcd`, `comp-ms`, `comm-ms` -- the NumPy oracles and the
                    paper's comparison schemes.
  * `portfolio`  -- best feasible outcome over a member set.

The torch solvers never fall back to the CPU: without a card they raise
unless the caller passes ``device="cpu"``.
"""
from .costmodel import (
    BW,
    FW,
    IF,
    PIPE,
    SCHEDULES,
    SEQ,
    TR,
    ComputeModel,
    LayerProfile,
    ModelProfile,
    even_split,
)
from .engine import (
    get_solver,
    portfolio_solve,
    register_solver,
    solve,
    solve_batch,
    solver_names,
    unregister_solver,
)
from .network import LinkSpec, NodeSpec, PhysicalNetwork
from .plan import EvalCache, LatencyBreakdown, Plan, ServiceChainRequest
from .problem import ProblemInstance, SolveOutcome, SolveResult
from .resnet101_profile import resnet101_profile
from .topology import DEST, NSFNET_NODES, SOURCE, candidate_sets, nsfnet

__all__ = [
    "BW", "FW", "IF", "TR", "SEQ", "PIPE", "SCHEDULES",
    "ComputeModel", "LayerProfile", "ModelProfile", "even_split",
    "get_solver", "portfolio_solve", "register_solver", "solve",
    "solve_batch", "solver_names", "unregister_solver",
    "LinkSpec", "NodeSpec", "PhysicalNetwork",
    "EvalCache", "LatencyBreakdown", "Plan", "ServiceChainRequest",
    "ProblemInstance", "SolveOutcome", "SolveResult",
    "resnet101_profile", "DEST", "NSFNET_NODES", "SOURCE", "candidate_sets",
    "nsfnet",
]
