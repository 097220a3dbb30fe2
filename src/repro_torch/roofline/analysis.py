"""Roofline terms of a dry-run cell on H100 clusters, the counterpart of
the JAX package's ``roofline/analysis.py``.

  compute term    = FLOPs per device / the card's bf16 peak
  memory term     = HBM bytes per device / the card's HBM rate
  collective term = NVLink bytes / NVLink rate + network bytes / network rate

The counts are per device (``roofline/op_cost.py`` counts the local ops a
device runs), so each term is per-device work over per-card rates.  A
collective moves its per-device volume by the ring formula of its type:
all-reduce 2(n-1)/n of the buffer, all-gather (n-1)/n of the gathered
buffer, reduce-scatter (n-1)/n of the input (n times the shard),
all-to-all (n-1)/n, a permute the buffer once.  A collective within the
``model`` axis (one NVLink node of 8 cards) runs on NVLink; one that spans
``data`` or ``pod`` crosses the network.  Where every byte lies on one link
the collective term is the reference's ``coll_bytes / ici_bw``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

from ..launch.mesh import HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS_BF16

# The JAX package's table of element types, by its HLO names.
DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_volume(op: str, out_bytes: float, n: int) -> float:
    """The per-device bytes of one collective of ``n`` ranks whose output
    (per device) is ``out_bytes``, as the JAX package's ``collective_stats``
    counts them (a group of fewer than 2 counts as 2)."""
    n = max(2, n)
    ring = (n - 1) / n
    if op == "all-reduce":
        return 2.0 * ring * out_bytes  # reduce-scatter + all-gather phases
    if op == "all-gather":
        return ring * out_bytes  # the output is the gathered buffer
    if op == "reduce-scatter":
        return ring * out_bytes * n  # the output is the shard
    if op == "all-to-all":
        return ring * out_bytes
    if op == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {op!r}")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_global: float
    # the part of coll_bytes_per_device that crosses the network (the rest
    # runs on NVLink); None puts every byte on NVLink
    net_bytes_per_device: float | None = None
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    nvlink_bw: float = NVLINK_BW
    net_bw: float = NET_BW

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / self.hbm_bw

    @property
    def t_collective(self) -> float:
        net = self.net_bytes_per_device or 0.0
        return ((self.coll_bytes_per_device - net) / self.nvlink_bw
                + net / self.net_bw)

    @property
    def t_bound(self) -> float:
        """The least time of the step on one card, collectives aside: the
        larger of the compute and memory terms."""
        return max(self.t_compute, self.t_memory)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOPs over the FLOPs the devices run: catches remat,
        masking and dispatch waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The share of the cards' peak that the model FLOPs would reach if
        the step ran at the bound of its dominant term."""
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        if t_bound <= 0:
            return 0.0
        achieved = self.model_flops_global / t_bound
        return achieved / (self.chips * self.peak_flops)

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


@dataclass
class ModuleCost:
    """Per-device counts of one step, with the JAX package's fields:
    FLOPs, HBM bytes, the collectives' ring bytes and counts by type, and
    the loops whose trip count was unknown (always 0 here: eager PyTorch
    runs every iteration).  ``net_coll_bytes`` is the part of the
    collective bytes that crosses the network."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_counts: dict = field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    unknown_trip_counts: int = 0
    net_coll_bytes: float = 0.0

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())
