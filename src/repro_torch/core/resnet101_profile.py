"""ResNet101 building-block profile — exact Table I of the paper.

37 layers (building blocks), 3x224x224 ImageNet input, b = 1 per-sample values.
FW FLOPs = 2 x MACs; BW FLOPs = 2 x FW FLOPs; smashed data / layer sizes assume
fp32.  M/K/G columns reproduced verbatim (decimal multipliers as in the paper).
"""
from __future__ import annotations

from .costmodel import LayerProfile, ModelProfile

M = 1e6
K = 1e3
G = 1e9

# (name, rho_FW, rho_BW, delta_FW, delta_BW, r_mem == r_disk)
_TABLE_I: list[tuple[str, float, float, float, float, float]] = []
_TABLE_I.append(("conv1", 236.02 * M, 472.04 * M, 3.21 * M, 3.21 * M, 37 * K))
_TABLE_I.append(("conv2_x_pre", 6.43 * M, 12.9 * M, 0.80 * M, 0.80 * M, 512))
_TABLE_I.append(("conv2_x_3", 4.74 * G, 9.48 * G, 3.21 * M, 3.21 * M, 3.02 * M))
for i in (4, 5):
    _TABLE_I.append((f"conv2_x_{i}", 7.40 * G, 14.80 * G, 3.21 * M, 3.21 * M, 4.72 * M))
_TABLE_I.append(("conv3_x_6", 5.76 * G, 11.52 * G, 1.61 * M, 1.61 * M, 14.68 * M))
for i in (7, 8, 9):
    _TABLE_I.append((f"conv3_x_{i}", 7.40 * G, 14.80 * G, 1.61 * M, 1.61 * M, 18.88 * M))
_TABLE_I.append(("conv4_x_10", 5.76 * G, 11.52 * G, 0.80 * M, 0.80 * M, 58.76 * M))
for i in range(11, 33):
    _TABLE_I.append((f"conv4_x_{i}", 7.40 * G, 14.80 * G, 0.80 * M, 0.80 * M, 75.52 * M))
_TABLE_I.append(("conv5_x_33", 5.76 * G, 11.52 * G, 0.40 * M, 0.40 * M, 234.92 * M))
for i in (34, 35):
    _TABLE_I.append((f"conv5_x_{i}", 7.40 * G, 14.80 * G, 0.40 * M, 0.40 * M, 302.04 * M))
_TABLE_I.append(("avgpool", 200.70 * K, 401.40 * K, 8192.0, 8192.0, 0.0))
_TABLE_I.append(("fc", 4.10 * M, 8.20 * M, 4000.0, 4000.0, 8.20 * M))

assert len(_TABLE_I) == 37


def resnet101_profile() -> ModelProfile:
    layers = [
        LayerProfile(name, fw, bw, act, grad, mem, mem)
        for (name, fw, bw, act, grad, mem) in _TABLE_I
    ]
    return ModelProfile("resnet101", layers)
