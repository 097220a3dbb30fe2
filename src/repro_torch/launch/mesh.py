"""Production meshes of H100 clusters, and the card's rates.

Single: 256 cards as ('data', 'model') = (32, 8), ``model`` being one
NVLink node of 8 cards.  Multi: 2 x 256 cards as ('pod', 'data', 'model')
= (2, 32, 8).  A mesh is a ``DeviceMesh`` over the process group the
caller has started: a fake one (:func:`start_fake_group`) for the dry run,
which allocates nothing and touches no device, or a real one on a cluster.
Defined as functions, so importing this module starts no group.
"""
from __future__ import annotations

SINGLE_SHAPE, SINGLE_AXES = (32, 8), ("data", "model")
MULTI_SHAPE, MULTI_AXES = (2, 32, 8), ("pod", "data", "model")

# NVIDIA H100 80GB HBM3, 700.00 W (as nvidia-smi prints the card and its
# power limit): NVIDIA's data sheet for the SXM part, dense rates.
PEAK_FLOPS_BF16 = 989.4e12  # bf16 dense FLOP/s on the tensor cores
HBM_BW = 3.35e12  # HBM bytes/s
NVLINK_BW = 450e9  # NVLink bytes/s each way (900 GB/s both ways)
NET_BW = 50e9  # bytes/s across nodes: one 400 Gb/s NDR port a card
# torch.cuda.get_device_properties(0).total_memory on that card
HBM_PER_CARD = 85_017_493_504
NVLINK_AXES = ("model",)  # mesh axes inside one NVLink node


def start_fake_group(world_size: int, rank: int = 0) -> None:
    """A fake process group of ``world_size`` ranks in this process, as
    ``rank``: collectives return at once and move nothing.  Process-global:
    one group at a time (``torch.distributed.destroy_process_group`` ends
    it)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the started
    process group (``device_type`` "cuda" on a real cluster)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    if multi_pod:
        return make_mesh(MULTI_SHAPE, MULTI_AXES, device_type)
    return make_mesh(SINGLE_SHAPE, SINGLE_AXES, device_type)
