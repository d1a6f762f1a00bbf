"""The route and tiling rule of the GRU kernels on a thread-block cluster:
the forward (K2, K3) and the backward (K9).

bfloat16 at H = 256 runs the cluster kernel of ``csrc/gru_cluster.cuh``:
a thread-block cluster of 8 CTAs (one an SM) takes N rows, each CTA keeps
the W_hh columns of its 32 hidden units resident in registers and runs
the step on ``wgmma`` (K2 also keeps its W_d columns in shared memory and
runs the downsample there). float32 K2 at H = 256 runs the same design in
exact f32 on the CUDA cores (``csrc/gru_cluster_f32.cuh``: W_hh's 96
columns of a CTA in registers over its 256 threads, W_d's 160 KB in shared
memory, h exchanged in f32, three h buffers so that the conv runs after
each step's send), at N = 2, 4, 8 or 9 rows: 16 rows would need 262,296
bytes of shared memory a CTA. float32 K3 and any H but 256 run the block
kernels (one block of 3H threads a row, W_hh read from L2 every step).
The rule is explicit and by dtype and shape only: a failed build or
launch raises, nothing retries another kernel.

``tiling`` picks C and N from (R, H): of the tilings the kernel is built
for whose shared memory fits an SM, the fewest waves of clusters (a
cluster count past what the card holds at once runs in more waves, each
as long as the first), then the fewest rows a cluster (a step's product
grows with N). The cluster is 8 CTAs: on the H100, C = 4 ran slower than
C = 8 at every R and N it could take, and C = 2 does not fit an SM. The
card tells how many clusters of a tiling it holds at once
(``cudaOccupancyMaxActiveClusters``); the caller passes that count. In
float32 the step is FFMA-bound, so its time grows with N and the rule's
order holds: at the inference batch (R = 128, 15 clusters resident) 9
rows a cluster run in one wave where 8 would need two.

K9 in bfloat16 at H = 256 runs the design of ``csrc/gru_bwd_cluster.cuh``
(the gate coefficients and dW_hh as tensor-core products over all rows and
steps, the reverse recurrence on an 8-CTA cluster with W_hh's columns of a
CTA's units resident in its registers); float32 (CPC) and any other H the
block kernel of ``csrc/gru_backward.cu``. ``backward_tiling`` applies the
same choice to the recurrence's tilings and shared memory.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

CLUSTER_HIDDEN = 256  # the one H the cluster kernel takes
MAX_SMEM = 232_448  # H100: a CTA's shared memory
STAGES = 3  # x_proj ring stages (csrc/gru_cluster.cuh STAGES)
TILE_BYTES = 256 * 128  # one resident m64 A tile of K2's W_d, K = H
NOUT_SLOTS = 4  # K2: downsample outputs in flight
K_HALVES = 2  # GRU warpgroups, each half of the K = H contraction
# (cluster, rows a cluster) the kernel is built for (csrc/gru_cluster.cuh
# dispatch)
RECURRENCE_TILINGS: Tuple[Tuple[int, int], ...] = ((8, 8), (8, 16), (8, 32))
DOWNSAMPLE_TILINGS: Tuple[Tuple[int, int], ...] = ((8, 8), (8, 16))
# float32 K2 (csrc/gru_cluster_f32.cuh dispatch and constants)
F32_DOWNSAMPLE_TILINGS: Tuple[Tuple[int, int], ...] = ((8, 2), (8, 4), (8, 8), (8, 9))
F32_K_SLICES = 8  # k-slices of the contraction over H (gcf::KSL)
F32_H_BUFFERS = 3  # h buffers (gcf::HBUFS)
F32_TAPS = 5  # downsample taps whose W_d columns stay resident (gcf::TAPS)
# K9's recurrence (csrc/gru_bwd_cluster.cuh dispatch and constants)
BACKWARD_TILINGS: Tuple[Tuple[int, int], ...] = ((8, 8), (8, 16), (8, 32))
BACKWARD_STAGES = 4  # coefficient / dys ring stages (gb::STAGES)
N_COEF = 5  # a_r, a_z, a_n, r, z (gb::NCOEF)

DESIGN = {
    "bfloat16": "H=256: cluster kernel (gru_cluster.cuh), W_hh resident over 8 CTAs, step on wgmma, "
                "rows a cluster by ops/gru_cluster.py tiling; other H: the block kernel",
    "float32": "K2 at H=256: cluster kernel (gru_cluster_f32.cuh), W_hh resident over 8 CTAs in registers, "
               "step and conv as f32 FFMA, W_d in shared memory, rows a cluster by ops/gru_cluster.py tiling; "
               "K3 and other H: the block kernel (one block of 3H threads a row, W_hh read from L2 each step)",
}


def smem_bytes(rows: int, cluster: int, fused: bool) -> int:
    """Dynamic shared bytes of one CTA, as ``gc::smem_bytes`` reckons them:
    alignment slack, K2's three W_d tiles, two h buffers (the rows' bf16 hi
    and lo halves), the x_proj ring, the exchange of the two K halves'
    sums (K2: of the GRU's and of the conv's), K2's output sums and LayerNorm statistics, and the buffers' two
    mbarriers."""
    units = CLUSTER_HIDDEN // cluster
    total = (1024 + 2 * 2 * 512 * rows + STAGES * rows * 3 * units * 2
             + K_HALVES * 128 * 2 * rows * 4 + 16)
    if fused:  # W_d, the conv's K-half exchange, the output sums and statistics
        total += (3 * TILE_BYTES + K_HALVES * 128 * 2 * rows * 4
                  + (NOUT_SLOTS * rows * 32 + 2 * cluster * rows + rows) * 4)
    return total


def f32_smem_bytes(rows: int, cluster: int) -> int:
    """Dynamic shared bytes of one CTA of the float32 K2 kernel, as
    ``gcf::smem_bytes`` reckons them: W_d's columns of the CTA's channels
    for every tap, three h buffers (f32, every unit of each row), the
    x_proj ring, the slice pairs' partial sums (which the conv's eight
    slices share), two outputs' conv sums, their row sums and squared
    deviations from every rank, their means, and the buffers' mbarriers."""
    units = CLUSTER_HIDDEN // cluster
    return (F32_TAPS * CLUSTER_HIDDEN * units * 4 + F32_H_BUFFERS * rows * CLUSTER_HIDDEN * 4
            + STAGES * rows * 3 * units * 4 + (F32_K_SLICES // 2) * 3 * rows * units * 4
            + 2 * rows * units * 4 + 2 * 2 * cluster * rows * 4 + 2 * rows * 4 + F32_H_BUFFERS * 8)


def backward_smem_bytes(rows: int, cluster: int) -> int:
    """Dynamic shared bytes of one CTA of K9's recurrence, as
    ``gb::smem_bytes`` reckons them: alignment slack, two B tiles (the
    rows' dg hi and lo halves over the CTA's 96 gate columns, two
    128-byte-swizzled panels each), two receive buffers and the send
    staging (f32, every rank's slice of the CTA's units), the coefficient
    and dys ring, and the buffers' two mbarriers."""
    units = CLUSTER_HIDDEN // cluster
    b_tiles = 2 * 2 * (2 * rows * 128)
    slices = 3 * cluster * rows * units * 4
    ring = BACKWARD_STAGES * rows * (N_COEF * units * 4 + units * 2)
    return 1024 + b_tiles + slices + ring + 16


@dataclass(frozen=True)
class Tiling:
    """``route`` "cluster": ``tiles`` clusters of ``cluster`` CTAs, ``rows``
    rows each (rows past R are zeros, never stored), in ``waves`` waves;
    ``smem`` bytes a CTA. ``route`` "block": one block a row."""

    route: str
    cluster: int = 1
    rows: int = 1
    tiles: int = 0
    waves: int = 1
    smem: int = 0


def tiling(rows: int, hidden: int, dtype: torch.dtype, fused: bool,
           max_clusters: Callable[[int, int], int]) -> Tiling:
    """The route and tiling for ``rows`` sequences of width ``hidden``;
    ``max_clusters(C, N)`` is how many clusters of that tiling the card holds
    at once (0: none)."""
    if hidden != CLUSTER_HIDDEN or dtype not in (torch.bfloat16, torch.float32):
        return Tiling("block", tiles=rows)
    if dtype == torch.float32:
        if not fused:  # K3's float32 route stays on its block kernel
            return Tiling("block", tiles=rows)
        return _pick(rows, F32_DOWNSAMPLE_TILINGS, lambda c, n: f32_smem_bytes(n, c), max_clusters)
    tilings = DOWNSAMPLE_TILINGS if fused else RECURRENCE_TILINGS
    return _pick(rows, tilings, lambda c, n: smem_bytes(n, c, fused), max_clusters)


def backward_tiling(rows: int, hidden: int, dtype: torch.dtype,
                    max_clusters: Callable[[int, int], int]) -> Tiling:
    """K9's route and the tiling of its recurrence, by the rule of
    ``tiling``: bfloat16 at H = 256 on the cluster design, anything else
    on the block kernel."""
    if dtype != torch.bfloat16 or hidden != CLUSTER_HIDDEN:
        return Tiling("block", tiles=rows)
    return _pick(rows, BACKWARD_TILINGS, lambda c, n: backward_smem_bytes(n, c), max_clusters)


def _pick(rows: int, tilings, smem_of: Callable[[int, int], int],
          max_clusters: Callable[[int, int], int]) -> Tiling:
    """Of ``tilings`` whose shared memory fits an SM, the fewest waves, then
    the fewest rows a cluster."""
    best = None
    for cluster, n in tilings:
        smem = smem_of(cluster, n)
        resident = max_clusters(cluster, n)
        if smem > MAX_SMEM or resident < 1:
            continue
        tiles = -(-rows // n)
        cand = Tiling("cluster", cluster, n, tiles, -(-tiles // resident), smem)
        key = (cand.waves, n, -cluster)
        if best is None or key < best[0]:
            best = (key, cand)
    if best is None:
        raise RuntimeError(f"gru cluster kernel: no tiling fits {rows} rows")
    return best[1]


_RESIDENT: Dict[Tuple[str, int, int], Tuple[int, int]] = {}


def card_max_clusters(lib: ctypes.CDLL, info: str) -> Callable[[int, int], int]:
    """``max_clusters`` from the card: the library's ``info`` entry point
    (``cudaOccupancyMaxActiveClusters`` at the kernel's shared memory),
    checked against ``smem_bytes``, once per tiling."""

    def query(cluster: int, n: int) -> int:
        key = (info, cluster, n)
        if key not in _RESIDENT:
            smem, resident = ctypes.c_int(0), ctypes.c_int(0)
            fn = getattr(lib, info)
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            rc = fn(cluster, n, ctypes.byref(smem), ctypes.byref(resident))
            if rc != 0:
                raise RuntimeError(f"{info}({cluster}, {n}): CUDA error {rc}")
            if "backward" in info:
                want = backward_smem_bytes(n, cluster)
            elif "f32" in info:
                want = f32_smem_bytes(n, cluster)
            else:
                want = smem_bytes(n, cluster, "downsample" in info)
            if smem.value != want:
                raise RuntimeError(f"{info}: the kernel takes {smem.value} shared bytes, the rule "
                                   f"reckons {want}")
            _RESIDENT[key] = (smem.value, resident.value)
        return _RESIDENT[key][1]

    return query
