"""``repro_torch.kernels`` has the JAX package's kernel API: the names of
``repro.kernels.__all__`` (``ops``, ``ref`` and the five wrappers), each
wrapper the one beside its kernel, ``ops`` with ``flash_attention``, and
``ref`` holding the plain versions under the JAX package's names."""
from __future__ import annotations

import importlib

import pytest

import repro.kernels as jk
import repro_torch.kernels as tk

# wrapper name -> the port's module that holds it and its plain version
WRAPPERS = {"flash_attention": ("flash_attention", "reference_attention"),
            "expert_matmul": ("moe_gmm", "reference_expert_matmul"),
            "minplus_matmul": ("minplus", "minplus_reference"),
            "rglru_scan": ("rglru", "reference_rglru_scan"),
            "ssd_intra_chunk": ("ssd", "reference_ssd_intra_chunk")}
REF_NAMES = {"reference_attention": "flash_attention",
             "reference_expert_matmul": "moe_gmm",
             "reference_minplus": "minplus",
             "reference_rglru_scan": "rglru",
             "reference_ssd_intra_chunk": "ssd"}


def _module(name):
    return importlib.import_module(f"repro_torch.kernels.{name}")


def test_the_port_exports_the_jax_package_names():
    assert set(tk.__all__) == set(jk.__all__)
    assert tk.ops is _module("ops") and tk.ref is _module("ref")


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_each_wrapper_is_the_one_beside_its_kernel(name):
    module, _ = WRAPPERS[name]
    assert getattr(tk, name) is getattr(_module(module), name)


@pytest.mark.parametrize("name", sorted(REF_NAMES))
def test_ref_holds_the_plain_versions(name):
    """Every name of the JAX package's ``ref`` that has a kernel in the
    port, bound to the plain version beside that kernel's wrapper."""
    assert hasattr(importlib.import_module("repro.kernels.ref"), name)
    module = _module(REF_NAMES[name])
    plain = dict(WRAPPERS.values())[REF_NAMES[name]]
    assert getattr(tk.ref, name) is getattr(module, plain)
    assert name in tk.ref.__all__


def test_ops_exports_flash_attention():
    assert "flash_attention" in tk.ops.__all__
    assert tk.ops.flash_attention is _module("flash_attention").flash_attention
    for name in tk.ops.__all__:
        assert callable(getattr(tk.ops, name))
