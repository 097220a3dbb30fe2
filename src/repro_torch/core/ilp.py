"""Faithful MILP of the paper's P_IF / P_TR (Sec. IV, Eqs. (1)-(15)).

Solved with scipy's HiGHS `milp` (exact branch-and-bound — Gurobi is not
installable offline; HiGHS returns provably optimal solutions, so this is the
paper's "ILP" scheme).  The non-linearities the paper mentions (products of
binaries in Eq. (16), the max in (12)/(15)) are linearized with the standard
techniques the paper cites [20]:

  * u_{k,l} = y_{k,l} (1 - y_{k,l+1})      -> AND linearization (cut indicator)
  * x * psi transmission products          -> big-M lower-bounded epigraph t_{k,e}
  * x * kappa compute products             -> big-M epigraph g_{k,i}
  * max(0, y_l - y_{l-1}) in (12)          -> rise variables m_{k,l}, sum = 1
  * max_l y delta in (15)                  -> peak variable h_k >= delta_l y_{k,l}

Subpath semantics follow Eq. (16): transmission + propagation are charged on
subpaths S_2..S_{K+1} (S_{K+1} ships psi_K = 0, i.e. propagation only); S_1 is
uncharged (V^1 is pinned to {s} in all evaluations, as in the paper).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp

from .costmodel import BW, FW, SEQ, TR, ModelProfile, dirs_for_mode
from .engine import register_solver
from .network import PhysicalNetwork, transmission_time_s
from .plan import Plan, PlanEvaluator, ServiceChainRequest
from .problem import SolveResult

EPS_SUBPATH1 = 1e-9  # tiny cost on S_1 physical edges to keep solutions loop-free


@dataclass
class _Var:
    lo: float
    hi: float
    integral: bool
    obj: float = 0.0


class _Builder:
    def __init__(self) -> None:
        self.vars: list[_Var] = []
        self.rows: list[tuple[dict[int, float], float, float]] = []

    def add_var(self, lo=0.0, hi=1.0, integral=False, obj=0.0) -> int:
        self.vars.append(_Var(lo, hi, integral, obj))
        return len(self.vars) - 1

    def add_row(self, coeffs: dict[int, float], lb: float, ub: float) -> None:
        self.rows.append((coeffs, lb, ub))

    def solve(self, time_limit_s: float | None):
        n = len(self.vars)
        c = np.array([v.obj for v in self.vars])
        integrality = np.array([1 if v.integral else 0 for v in self.vars])
        bounds = Bounds(np.array([v.lo for v in self.vars]),
                        np.array([v.hi for v in self.vars]))
        data, ri, ci, lbs, ubs = [], [], [], [], []
        for r, (coeffs, lb, ub) in enumerate(self.rows):
            for j, a in coeffs.items():
                ri.append(r)
                ci.append(j)
                data.append(a)
            lbs.append(lb)
            ubs.append(ub)
        A = sparse.csr_matrix((data, (ri, ci)), shape=(len(self.rows), n))
        cons = LinearConstraint(A, np.array(lbs), np.array(ubs))
        options = {"mip_rel_gap": 1e-9}
        if time_limit_s is not None:
            options["time_limit"] = time_limit_s
        return milp(c=c, constraints=cons, integrality=integrality, bounds=bounds,
                    options=options)


@register_solver("ilp", schedules=(SEQ,), optimal=True,
                 description="faithful HiGHS MILP of Eqs. (1)-(15); "
                             "sequential schedule only")
def ilp_solve(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    time_limit_s: float | None = 1000.0,
    cache: object | None = None,  # accepted for solver-API uniformity; the MILP
    # builds its own coefficient tables and has nothing to memoize across calls.
) -> SolveResult:
    # The MILP linearizes the *sequential* Eq. (16) objective; the pipelined
    # bottleneck max has no formulation here.  The capability check yields the
    # same uniform error as the engine path for direct/legacy callers.
    from .engine import ensure_solver_supported

    ensure_solver_supported("ilp", schedule=request.schedule,
                            batch_size=request.batch_size,
                            n_microbatches=request.n_microbatches)
    t0 = time.perf_counter()
    L = profile.L
    b = request.batch_size
    dirs = dirs_for_mode(request.mode)
    phys_edges = sorted(net.links)
    B = _Builder()

    # ---------------------------------------------------------------- variables
    # x[k][edge]: subpaths k = 1..K+1 over the augmented edge set (constraint (5)
    # enforced structurally: only subpath k may enter v_hat_k, only subpath k+1
    # may leave it).
    x: list[dict[tuple, int]] = [dict() for _ in range(K + 2)]
    for k in range(1, K + 2):
        prop = 0.0 if k == 1 else None  # propagation charged on S_2..S_{K+1}
        for (u_, v_) in phys_edges:
            link = net.links[(u_, v_)]
            if k == 1:
                cost = EPS_SUBPATH1
            else:
                cost = link.delay_fw + (link.delay_bw if request.mode == TR else 0.0)
            x[k][(u_, v_)] = B.add_var(0, 1, True, obj=cost)
        if k <= K:  # (i, v_hat_k) entries
            for i in candidates[k - 1]:
                x[k][(i, ("hat", k))] = B.add_var(0, 1, True)
        if k >= 2:  # (v_hat_{k-1}, i) exits
            for i in candidates[k - 2]:
                x[k][(("hat", k - 1), i)] = B.add_var(0, 1, True)

    y = [[B.add_var(0, 1, True) for _ in range(L + 1)] for _ in range(K + 1)]  # y[k][l], 1-idx
    u = [[B.add_var(0, 1, False) for _ in range(L)] for _ in range(K)]  # u[k][l], k=1..K-1 used
    mv = [[B.add_var(0, 1, False) for _ in range(L + 1)] for _ in range(K + 1)]
    h = [B.add_var(0, np.inf, False) for _ in range(K + 1)]  # h[k], 1-idx

    # ------------------------------------------------------- splitting constraints
    B.add_row({y[1][1]: 1}, 1, 1)  # (7)
    B.add_row({y[K][L]: 1}, 1, 1)  # (8)
    for l in range(1, L + 1):  # (9)
        B.add_row({y[k][l]: 1 for k in range(1, K + 1)}, 1, 1)
    for k in range(1, K + 1):  # (10)
        B.add_row({y[k][l]: 1 for l in range(1, L + 1)}, 1, np.inf)
    for k in range(1, K + 1):  # (11)-(12): rise vars, y[k][0] == 0 dummy
        B.add_row({mv[k][1]: 1, y[k][1]: -1}, 0, np.inf)
        for l in range(2, L + 1):
            B.add_row({mv[k][l]: 1, y[k][l]: -1, y[k][l - 1]: 1}, 0, np.inf)
        B.add_row({mv[k][l]: 1 for l in range(1, L + 1)}, 1, 1)
    for k in range(2, K + 1):  # (13)
        for l in range(2, L + 1):
            B.add_row({y[k][l]: 1, y[k][l - 1]: -1, y[k - 1][l - 1]: -1},
                      -np.inf, 0)
    for k in range(1, K):  # u = AND(y_l, NOT y_{l+1}); exactly one cut per k < K
        for l in range(1, L):
            B.add_row({u[k][l - 1]: 1, y[k][l]: -1}, -np.inf, 0)
            B.add_row({u[k][l - 1]: 1, y[k][l + 1]: 1}, -np.inf, 1)
            B.add_row({u[k][l - 1]: 1, y[k][l]: -1, y[k][l + 1]: 1}, 0, np.inf)
        B.add_row({u[k][l - 1]: 1 for l in range(1, L)}, 1, 1)
    for k in range(1, K + 1):  # h_k >= delta_l^dir y_{k,l}
        for l in range(1, L + 1):
            for d in dirs:
                delta = (profile.layers[l - 1].act_bytes if d == FW
                         else profile.layers[l - 1].grad_bytes)
                B.add_row({h[k]: 1, y[k][l]: -delta}, 0, np.inf)

    # ------------------------------------------------- flow conservation (2)-(4)
    def nodes_of_subpath(k: int) -> list:
        ns: list = list(net.nodes)
        if 2 <= k:
            ns.append(("hat", k - 1))
        if k <= K:
            ns.append(("hat", k))
        return ns

    for k in range(1, K + 2):
        a_k = request.source if k == 1 else ("hat", k - 1)
        b_k = ("hat", k) if k <= K else request.destination
        for nd in nodes_of_subpath(k):
            coeffs: dict[int, float] = {}
            for e, idx in x[k].items():
                if e[0] == nd:
                    coeffs[idx] = coeffs.get(idx, 0.0) + 1.0
                if e[1] == nd:
                    coeffs[idx] = coeffs.get(idx, 0.0) - 1.0
            rhs = 1.0 if nd == a_k else (-1.0 if nd == b_k else 0.0)
            if coeffs or rhs:
                B.add_row(coeffs, rhs, rhs)
    for k in range(1, K + 1):  # (4) connectivity
        for i in candidates[k - 1]:
            B.add_row({x[k][(i, ("hat", k))]: 1, x[k + 1][(("hat", k), i)]: -1}, 0, 0)

    # -------------------------------------- computation epigraph g (Eqs. 16-17)
    g: dict[tuple[int, str], int] = {}
    for k in range(1, K + 1):
        for i in candidates[k - 1]:
            cm = net.nodes[i].compute
            coefs = np.zeros(L + 1)
            tau_total = 0.0
            for d in dirs:
                a_, beta_ = cm._coeffs(b)
                for l in range(1, L + 1):
                    coefs[l] += (a_ * b + beta_) / 1e3 * profile.layers[l - 1].flops(d)
                tau_total += cm.tau_s(b)
            gi = B.add_var(0, np.inf, False, obj=1.0)
            g[(k, i)] = gi
            M = float(coefs.sum()) + tau_total
            row = {gi: 1.0, x[k][(i, ("hat", k))]: -M}
            for l in range(1, L + 1):
                row[y[k][l]] = -float(coefs[l])
            B.add_row(row, tau_total - M, np.inf)

    # ------------------------------------- transmission epigraph t (Eqs. 16, 18)
    for k in range(1, K):  # cut k ships on subpath k+1
        for (u_, v_) in phys_edges:
            link = net.links[(u_, v_)]
            w = np.zeros(L)  # w[l-1]: cost if cut after layer l
            for l in range(1, L):
                w[l - 1] += transmission_time_s(b * profile.cut_bytes(l, FW), link.bw_fw)
                if request.mode == TR:
                    w[l - 1] += transmission_time_s(b * profile.cut_bytes(l, BW), link.bw_bw)
            M = float(w.max())
            ti = B.add_var(0, np.inf, False, obj=1.0)
            row = {ti: 1.0, x[k + 1][(u_, v_)]: -M}
            for l in range(1, L):
                row[u[k][l - 1]] = -float(w[l - 1])
            B.add_row(row, -M, np.inf)

    # --------------------------------------------- capacity (14) and (15) big-M
    for k in range(1, K + 1):
        for i in candidates[k - 1]:
            spec = net.nodes[i]
            xi = x[k][(i, ("hat", k))]
            Md = sum(l.disk_bytes for l in profile.layers)
            row = {xi: Md}
            for l in range(1, L + 1):
                row[y[k][l]] = profile.layers[l - 1].disk_bytes
            B.add_row(row, -np.inf, spec.disk_capacity + Md)
            peak = max(max(l.act_bytes, l.grad_bytes) for l in profile.layers)
            Mm = sum(l.mem_bytes for l in profile.layers) + b * peak
            row = {xi: Mm, h[k]: b}
            for l in range(1, L + 1):
                row[y[k][l]] = profile.layers[l - 1].mem_bytes
            B.add_row(row, -np.inf, spec.mem_capacity + Mm)

    res = B.solve(time_limit_s)
    wall = time.perf_counter() - t0
    if res.status != 0 or res.x is None:
        return SolveResult(None, None, wall, solver="ilp")

    # ------------------------------------------------------------- extraction
    xv = res.x

    def sel(idx: int) -> bool:
        return xv[idx] > 0.5

    segments = []
    for k in range(1, K + 1):
        ls = [l for l in range(1, L + 1) if sel(y[k][l])]
        segments.append((min(ls), max(ls)))
    placement = []
    for k in range(1, K + 1):
        hosts = [i for i in candidates[k - 1] if sel(x[k][(i, ("hat", k))])]
        assert len(hosts) == 1, f"subpath {k}: hosts={hosts}"
        placement.append(hosts[0])

    def walk(k: int, start: str, goal: str) -> list[str]:
        succ = {}
        for (e, idx) in x[k].items():
            if isinstance(e[0], str) and isinstance(e[1], str) and sel(idx):
                succ[e[0]] = e[1]
        path, cur = [start], start
        while cur != goal:
            cur = succ[cur]
            path.append(cur)
        return path

    paths = [walk(k + 2, placement[k], placement[k + 1]) for k in range(K - 1)]
    tail = walk(K + 1, placement[K - 1], request.destination)
    plan = Plan(segments=segments, placement=placement, paths=paths,
                tail_path=tail if len(tail) > 1 else [])
    ev = PlanEvaluator(net, profile, request)
    ev.check(plan)
    latency = ev.evaluate(plan)
    # self-check: extracted plan must reproduce the MILP objective
    if abs(latency.total_s - res.fun) > 1e-6 + 1e-6 * abs(res.fun):
        raise AssertionError(
            f"ILP objective {res.fun} != extracted plan latency {latency.total_s}")
    return SolveResult(plan, latency, wall, solver="ilp")
