"""Network topologies: NSFNET (paper Sec. VI-A2), random G(V, p), TPU pod graphs."""
from __future__ import annotations

import random

from .costmodel import CPU_XEON_6226R, GPU_RTX_A6000, tpu_group_compute_model
from .network import LinkSpec, NodeSpec, PhysicalNetwork

GB = 1024**3
GBPS = 1e9  # 1 Gb/s in bits/s

# The paper's NSFNET node ordering (v1..v14) and its source/destination pair.
# Candidate sampling is seeded, so the ordering is part of the reproducible
# scenario definition.
NSFNET_NODES = [f"v{i}" for i in range(1, 15)]
SOURCE, DEST = "v4", "v13"

# NSFNET 14-node / 21-undirected-edge (42 directed links) topology with fiber
# distances in km (standard published distance set; the paper does not print its
# table, only the resulting propagation-delay range 1.23--14.2 ms).
NSFNET_EDGES_KM: list[tuple[int, int, float]] = [
    (1, 2, 1100), (1, 3, 1600), (1, 8, 2800),
    (2, 3, 600), (2, 4, 1000),
    (3, 6, 2000),
    (4, 5, 600), (4, 11, 2400),
    (5, 6, 1100), (5, 7, 800),
    (6, 10, 1200), (6, 13, 2000),
    (7, 8, 700),
    (8, 9, 700),
    (9, 10, 900), (9, 12, 500), (9, 13, 500),
    (11, 12, 800), (11, 14, 800),
    (12, 14, 600),
    (13, 14, 300),
]
FIBER_SPEED_KM_S = 2.0419e5  # c / 1.468 (speed of light in optical fiber)


def propagation_delay_s(dist_km: float) -> float:
    return dist_km / FIBER_SPEED_KM_S


def nsfnet(
    source: str = "v4",
    gpu_mem_gb: float = 2.0,
    cpu_mem_gb: float = 8.0,
    bandwidth_bps: float = GBPS,
) -> PhysicalNetwork:
    """NSFNET with the paper's node setup: `source` is the sole CPU node (8 GB),
    all others GPU nodes (2 GB); every link 1 Gb/s both directions."""
    net = PhysicalNetwork()
    for i in range(1, 15):
        name = f"v{i}"
        if name == source:
            net.add_node(NodeSpec(name, CPU_XEON_6226R, cpu_mem_gb * GB, cpu_mem_gb * GB))
        else:
            net.add_node(NodeSpec(name, GPU_RTX_A6000, gpu_mem_gb * GB, gpu_mem_gb * GB))
    for u, v, km in NSFNET_EDGES_KM:
        d = propagation_delay_s(km)
        net.add_bidirectional(f"v{u}", f"v{v}", LinkSpec(bandwidth_bps, bandwidth_bps, d, d))
    return net


def random_network(
    n_nodes: int,
    p: float = 0.2,
    seed: int = 0,
    source: str | None = None,
    bandwidth_bps: float = GBPS,
) -> PhysicalNetwork:
    """Random graphs for the scalability study (paper Sec. VI-D): each node pair is
    linked with probability p; a ring backbone guarantees connectivity; delays are
    drawn from the paper's NSFNET propagation-delay range."""
    rng = random.Random(seed)
    net = PhysicalNetwork()
    names = [f"v{i}" for i in range(1, n_nodes + 1)]
    source = source or names[0]
    for name in names:
        if name == source:
            net.add_node(NodeSpec(name, CPU_XEON_6226R, 8 * GB, 8 * GB))
        else:
            net.add_node(NodeSpec(name, GPU_RTX_A6000, 2 * GB, 2 * GB))
    # Connectivity ring, normalized to (min, max) like the random edges below:
    # the wraparound pair {v1, vN} must be stored as (0, n-1), not (n-1, 0),
    # or a random draw of (0, n-1) would re-add the same undirected link —
    # silently overwriting it, double-counting the edge in sorted(edges), and
    # shifting the seeded delay stream.
    edges = {tuple(sorted((i, (i + 1) % n_nodes))) for i in range(n_nodes)
             if n_nodes > 1}
    for i in range(n_nodes):
        for j in range(i + 1, n_nodes):
            if rng.random() < p:
                edges.add((i, j))
    for i, j in sorted(edges):
        d = rng.uniform(1.23e-3, 14.2e-3)
        net.add_bidirectional(names[i], names[j], LinkSpec(bandwidth_bps, bandwidth_bps, d, d))
    return net


def candidate_sets(K: int, seed: int, nodes: list[str],
                   source: str, dest: str, per_stage: int = 2) -> list[list[str]]:
    """Paper Sec. VI-A2 candidate policy: first/last stage pinned to s/d; each
    intermediate sub-model gets `per_stage` randomly, distinctly selected
    candidate nodes."""
    rng = random.Random(seed * 1000 + K)
    mids = [n for n in nodes if n not in (source, dest)]
    n_needed = per_stage * (K - 2)
    if n_needed > len(mids):
        raise ValueError(
            f"candidate_sets: K={K} with per_stage={per_stage} needs "
            f"{n_needed} distinct intermediate nodes but only {len(mids)} "
            f"are available (|nodes|={len(nodes)} minus source/destination); "
            f"lower K or per_stage, or use a larger topology")
    picked = rng.sample(mids, n_needed) if K > 2 else []
    cands = [[source]]
    for k in range(K - 2):
        cands.append(picked[per_stage * k : per_stage * (k + 1)])
    cands.append([dest])
    return cands


# ---------------------------------------------------------------- TPU adaptation
V5E_HBM_GB = 16.0
ICI_LINK_BPS = 50e9 * 8  # ~50 GB/s per ICI link
DCN_LINK_BPS = 25e9 * 8  # inter-pod data-center network
ICI_HOP_DELAY_S = 1e-6
DCN_HOP_DELAY_S = 10e-6


def tpu_pod_topology(
    n_groups: int = 16,
    chips_per_group: int = 16,
    n_pods: int = 1,
    mfu: float = 0.5,
) -> PhysicalNetwork:
    """TPU-native planner graph (DESIGN.md Sec. 2.2): each node is a stage group of
    `chips_per_group` v5e chips; groups within a pod form an ICI ring; pods are
    joined by DCN links between their first groups.  HBM of the group is the
    planner's memory capacity (constraint (15))."""
    net = PhysicalNetwork()
    cm = tpu_group_compute_model(chips_per_group, mfu=mfu)
    hbm = chips_per_group * V5E_HBM_GB * GB
    for p in range(n_pods):
        for g in range(n_groups):
            net.add_node(NodeSpec(f"p{p}g{g}", cm, hbm, hbm))
    for p in range(n_pods):
        for g in range(n_groups):
            u, v = f"p{p}g{g}", f"p{p}g{(g + 1) % n_groups}"
            net.add_bidirectional(u, v, LinkSpec(ICI_LINK_BPS, ICI_LINK_BPS,
                                                 ICI_HOP_DELAY_S, ICI_HOP_DELAY_S))
    for p in range(n_pods - 1):
        net.add_bidirectional(f"p{p}g0", f"p{p + 1}g0",
                              LinkSpec(DCN_LINK_BPS, DCN_LINK_BPS,
                                       DCN_HOP_DELAY_S, DCN_HOP_DELAY_S))
    return net
