"""The port's roofline layer (``repro_torch.roofline``) against the JAX
package's, on the CPU: the roofline terms and the collective volumes on
the reference tests' inputs, the trip-count toy of
``tests/test_roofline.py`` counted by ``OpCost`` (unsharded against the
reference's HLO analysis, sharded on 4 fake ranks against the reference
toy's own bounds), a reduced model's counted FLOPs against
``models/profiles.py``, and the kernels' work formulas against PERF.md's
bound column.  The fake process group is process-global, so the toys run
in subprocesses.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.roofline.analysis import Roofline as JaxRoofline
from repro.roofline.analysis import collective_stats
from repro_torch.configs import ARCHS
from repro_torch.models import profiles
from repro_torch.roofline import Roofline, ring_volume
from repro_torch.roofline import kernel_work as K
from repro_torch.roofline.op_cost import OpCost

SRC = str(Path(__file__).resolve().parents[1] / "src")
REF_RATES = dict(peak_flops=197e12, hbm_bw=819e9)


def _run(code: str, timeout: int = 240) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("coll", [0.5, 5.0])
def test_roofline_terms_match_the_reference(coll):
    kw = dict(arch="a", shape="s", mesh="m", chips=256,
              flops_per_device=197e12, hbm_bytes_per_device=819e9 * 2,
              coll_bytes_per_device=50e9 * coll,
              model_flops_global=197e12 * 256)
    ref = JaxRoofline(**kw)
    got = Roofline(**kw, **REF_RATES, nvlink_bw=50e9, net_bw=50e9)
    for name in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "useful_flops_ratio", "roofline_fraction"):
        assert getattr(got, name) == pytest.approx(getattr(ref, name)), name
    # the same bytes split between the links: NVLink's share at its rate
    split = Roofline(**dict(kw, coll_bytes_per_device=100e9),
                     net_bytes_per_device=50e9)
    assert split.t_collective == pytest.approx(50e9 / 450e9 + 50e9 / 50e9)


def test_collective_volumes_match_the_reference():
    hlo = """
ENTRY %main () -> f32[] {
  %ar = f32[1024]{0} all-reduce(%x), replica_groups={{0,1,2,3}}
  %ag = f32[4096]{0} all-gather(%y), replica_groups=[1,4]<=[4], dimensions={0}
  %rs = f32[256]{0} reduce-scatter(%z), replica_groups={{0,1,2,3}}
  %aa = f32[512]{0} all-to-all(%u), replica_groups={{0,1,2,3}}
  %cp = f32[512]{0} collective-permute(%w), source_target_pairs={{0,1}}
}
"""
    ref = collective_stats(hlo, 4)["bytes_per_device"]
    out = {"all-reduce": 1024, "all-gather": 4096, "reduce-scatter": 256,
           "all-to-all": 512, "collective-permute": 512}
    for op, n in out.items():
        assert ring_volume(op, 4 * n, 4) == pytest.approx(ref[op]), op


TOY_JAX = r"""
import json, jax, jax.numpy as jnp
from repro.roofline.hlo_cost import analyze_hlo
def step(w, x):
    def body(h, wi):
        return jnp.tanh(h @ wi), None
    h, _ = jax.lax.scan(body, x, w)
    return h.sum()
ws = jax.ShapeDtypeStruct((7, 64, 64), jnp.float32)
xs = jax.ShapeDtypeStruct((8, 64), jnp.float32)
mc = analyze_hlo(jax.jit(step).lower(ws, xs).compile().as_text(), 1)
print(json.dumps({"flops": mc.flops, "unknown": mc.unknown_trip_counts}))
"""

TOY_TORCH = r"""
import json, sys, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.roofline.op_cost import OpCost
SHARDED = sys.argv[1] == "sharded"
if SHARDED:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh, start_fake_group
    from repro_torch.models.sharding import MeshRules, constrain, mesh_rules
    start_fake_group(4)
    mesh = make_mesh((4,), ("data",))
with FakeTensorMode():
    w, x = torch.randn(7, 64, 64), torch.randn(8, 64)
    if SHARDED:
        w = distribute_tensor(w, mesh, [Shard(1)])
        x = distribute_tensor(x, mesh, [Replicate()])
        rules = mesh_rules(MeshRules(mesh, batch=("data",)))
    else:
        mesh, rules = None, torch.no_grad()
    with rules, OpCost(mesh) as oc:
        h = x
        for i in range(7):
            if SHARDED:  # the toy's constraint inside the loop
                h = constrain(h, ("batch", None))
            h = torch.tanh(h @ w[i])
        h.sum()
print(json.dumps({"flops": oc.cost.flops, "coll": oc.cost.total_coll_bytes,
                  "counts": oc.cost.coll_counts}))
"""


def _toy(kind: str) -> dict:
    return _run(TOY_TORCH.replace("sys.argv[1]", repr(kind)))


def test_toy_flops_match_the_reference_hlo_analysis():
    ref = _run(TOY_JAX)
    got = _toy("unsharded")
    expected = 7 * 2 * 8 * 64 * 64
    assert ref["unknown"] == 0
    # the reference counts tanh and the sum at 1 an element, as the port
    assert got["flops"] == pytest.approx(ref["flops"], rel=0.01)
    assert expected <= got["flops"] <= expected * 1.05
    assert got["coll"] == 0


def test_sharded_toy_meets_the_reference_toy_bounds():
    got = _toy("sharded")
    expected = 7 * 2 * 8 * 64 * 64
    # tests/test_roofline.py:45-49: per-device FLOPs, and the weight slices
    # gathered in every one of the 7 iterations
    assert expected / 4 * 0.9 <= got["flops"] <= expected * 1.3
    per_iter = 0.75 * 64 * 64 * 4
    assert got["coll"] >= 5 * per_iter
    assert got["counts"]["all-gather"] == 7


def _counted(cfg, B: int, S: int, train: bool):
    """(products and kernels' FLOPs, all FLOPs) of a forward or a train
    step of ``cfg`` at B x S on one device, fake tensors."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import Ctx
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_train_step

    with FakeTensorMode():
        params = T.init_params(torch.Generator(), cfg, device="cpu")
        tokens = torch.zeros((B, S), dtype=torch.int64)
        if train:
            opt = make_optimizer(cfg.optimizer)
            state = opt.init(params, cfg)
            step = make_train_step(cfg, opt)
        with OpCost() as oc:
            if train:
                step(params, state, {"tokens": tokens, "targets": tokens})
            else:
                with torch.no_grad():
                    pos = torch.arange(S).expand(B, S)
                    T.forward(params, cfg, tokens, Ctx("train", pos))
    main = sum(v for k, v in oc.flops_by_op.items()
               if k in ("mm", "addmm", "bmm", "baddbmm") or k in K.WORK)
    return main, oc.cost.flops


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-14b"])
def test_reduced_model_flops_match_the_profiles(arch):
    """The products and kernels counted against ``model_profile``'s FLOPs.
    Where the conventions differ: the profile counts the embedding's lookup
    as 2 S D (the port: 0, a gather), causal attention as S^2 / 2 pairs
    (the port S (S + 1) / 2), and no elementwise math or norms (the port 1
    an element; they are the difference between the two counts here); its
    head is counted at every position, as the port's loss computes it.  A
    train step is the forward 4 times (a backward twice the forward, and
    the forward again under remat), the optimizer's updates elementwise."""
    cfg = ARCHS[arch].reduced(n_layers=4, d_model=128, d_ff=256,
                              vocab_size=512, head_dim=32)
    B, S = 2, 128
    prof = profiles.model_profile(cfg, seq_len=S, mode="train")
    fw = B * sum(layer.flops_fw for layer in prof.layers)
    embed = B * 2 * S * cfg.d_model
    head = B * 2 * S * cfg.d_model * cfg.vocab_size
    main, total = _counted(cfg, B, S, train=False)
    # the forward runs no head (the loss does)
    assert main == pytest.approx(fw - embed - head, rel=0.01)
    assert main <= total <= 1.25 * main
    main, total = _counted(cfg, B, S, train=True)
    # the blocks 4 times (remat) but each layer's last product, the MLP's
    # down projection: the non-reentrant checkpoint stops recomputing once
    # the tensors the backward saved are back; the head 3 times plus its
    # recompute in the backward; and the flash backward's five products
    # are 2.5 times its forward's where the profile's backward is twice
    down = B * 2 * S * cfg.d_ff * cfg.d_model
    core = B * cfg.n_layers * 4 * S * S / 2 * cfg.n_heads * cfg.head_dim
    want = (4 * (fw - embed - head) - cfg.n_layers * down + 4 * head
            + core / 2)
    assert main == pytest.approx(want, rel=0.01)
    assert main <= total <= 1.25 * main


@pytest.mark.parametrize("kernel, key, us, by, work", [
    # PERF.md section 6, the bound column
    ("flash_attention", (2, 2048, 12, 2048, 2, 128, True, None, None),
     26.1, "operations", 25.8e9),
    ("flash_attention_bwd", (2, 2048, 12, 2048, 2, 128, True, None, None),
     65.2, "operations", 64.5e9),
    ("flash_attention", (1, 4096, 16, 4096, 1, 256, True, 2048, None),
     104.2, "operations", None),
    ("moe_gmm", (128, 2, 2048, 768, "none"), 120.6, "bytes", 404e6),
    ("moe_gmm", (128, 2400, 2048, 768, "none"), 977.1, "operations", 966e9),
    ("ssd", (2, 8, 32, 256, 64, 128), 26.9, "operations", 4.44e9),
    ("rglru_bwd", (1, 4096, 4096), 100.2, "bytes", 335.5e6),
])
def test_kernel_bounds_reproduce_the_perf_table(kernel, key, us, by, work):
    ms, bound_by, n_ops, n_bytes = K.kernel_bound(kernel, key)
    assert ms * 1e3 == pytest.approx(us, abs=0.05)
    assert bound_by == by
    if work is not None:
        got = n_ops if by == "operations" else n_bytes
        assert got == pytest.approx(work, rel=0.003)


def test_visible_pairs_match_the_mask():
    for Sq, Skv, causal, window in [(37, 37, True, None), (5, 40, True, 3),
                                    (40, 5, False, 7), (64, 64, True, 16),
                                    (33, 17, False, None), (1, 9, True, 2)]:
        qi = torch.arange(Sq)[:, None]
        ki = torch.arange(Skv)[None, :]
        mask = torch.ones((Sq, Skv), dtype=torch.bool)
        if causal:
            mask &= qi >= ki
        if window is not None:
            mask &= qi - ki < window
        assert K.visible_pairs(Sq, Skv, causal, window) == int(mask.sum())
    # a device's share of a sequence split over 4 ranks: a quarter
    key = (1, 256, 4, 1024, 1, 64, True, None, None, 4)
    assert K.flash_work(key)[0] * 4 == K.flash_work(
        (1, 1024, 4, 1024, 1, 64, True, None, None))[0]


def test_stand_ins_record_forward_and_backward_work():
    """On fake operands the wrappers record their kernels' work and return
    outputs of the right shapes; the backward records the backward
    kernel's."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import expert_matmul

    seen = []
    with FakeTensorMode(), K.recording(lambda *a: seen.append(a[:2])):
        q = torch.randn(2, 64, 4, 16, dtype=torch.bfloat16,
                        requires_grad=True)
        kv = torch.randn(2, 64, 2, 16, dtype=torch.bfloat16)
        out = flash_attention(q, kv, kv)
        assert out.shape == q.shape and out.dtype == q.dtype
        out.sum().backward()
        x = torch.randn(4, 8, 32, dtype=torch.bfloat16)
        y = expert_matmul(x, torch.randn(4, 32, 16, dtype=torch.bfloat16),
                          activation="silu")
        assert y.shape == (4, 8, 16)
    assert [k for k, _ in seen] == ["flash_attention", "flash_attention_bwd",
                                    "moe_gmm"]
    assert q.grad.shape == q.shape

