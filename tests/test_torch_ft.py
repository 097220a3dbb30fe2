"""The port's fault-tolerance controller (``repro_torch.ft``) against the
JAX package's ``repro.ft``, on the scenarios of the fault-tolerance half of
``tests/test_ckpt_ft.py``: a training chain on NSFNET x ResNet-101 that
loses the node hosting its middle stage, gets it back and loses the other
candidate, and one whose middle node reports step times ten times its
model's.  Every event, plan and latency is ``==`` the reference's; only the
milliseconds a replan took, which its event text carries, are left out."""
from __future__ import annotations

import re

import pytest

import repro.core as R
import repro.ft as RF
import repro_torch.core as T
import repro_torch.ft as TF

CANDS = [["v4"], ["v7", "v11"], ["v13"]]


def _controller(core, ft, **kw):
    net = core.nsfnet(source="v4")
    req = core.ServiceChainRequest("resnet101", "v4", "v13", 8, core.TR)
    return ft.ElasticPlanController(net, core.resnet101_profile(), req, 3,
                                    CANDS, **kw)


def _failures(ctl):
    first = ctl.plan.placement[1]
    other = next(n for n in CANDS[1] if n != first)
    plans = [ctl.fail_node(first, step=10)]
    plans.append(ctl.recover_node(first, step=20))
    plans.append(ctl.fail_node(other, step=30))
    return plans


def _straggler(ctl):
    node = ctl.plan.placement[1]
    flops = 1e12
    plans = []
    for step, b in ((1, 8), (2, 16)):
        slow = 10 * ctl.net.nodes[node].compute.comp_time_s(b, flops)
        plans.append(ctl.observe_step(step, node, b, flops, slow))
    return plans


def _view(ctl, plans):
    def plain(p):
        return None if p is None else (
            tuple(map(tuple, p.segments)), tuple(p.placement),
            tuple(map(tuple, p.paths)), tuple(p.tail_path))

    events = [(e.step, e.kind, re.sub(r" in [0-9.]+ms", "", e.detail))
              for e in ctl.events]
    return (events, [plain(p) for p in plans], plain(ctl.plan),
            ctl.result.latency_s, ctl.down_nodes)


@pytest.mark.parametrize("solver", [
    dict(solver="bcd_torch", solver_kwargs={"device": "cpu"}),
    dict(solver="bcd")], ids=["bcd_torch", "bcd"])
@pytest.mark.parametrize("scenario", [_failures, _straggler],
                         ids=["failures", "straggler"])
def test_controller_matches_the_reference(scenario, solver):
    """The port's controller with its default ``bcd_torch`` (on the CPU
    here) and with the host ``bcd``, against the reference's ``bcd``."""
    want_ctl, got_ctl = _controller(R, RF), _controller(T, TF, **solver)
    assert _view(got_ctl, []) == _view(want_ctl, [])
    want = _view(want_ctl, scenario(want_ctl))
    got = _view(got_ctl, scenario(got_ctl))
    assert got == want
    kinds = {kind for _, kind, _ in got[0]}
    assert {"failure", "restore", "replan"} <= kinds or "straggler" in kinds
