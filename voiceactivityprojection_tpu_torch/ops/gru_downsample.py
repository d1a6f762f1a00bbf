"""GRU recurrence fused with the causal downsample, LayerNorm and GELU.

Replaces the TPU kernel ``_gru_ds_kernel`` of
``voiceactivityprojection_tpu/ops/gru_pallas.py`` (entry point
``gru_downsample_fused``, :185): the GRU recurrence over precomputed input
projections (gate order r, z, n; gate math and carry in f32), then the
causal conv k=5, s=2 (a 4-frame zero left tail), LayerNorm (eps 1e-5) and
exact-erf GELU. (R, T, 3H) -> (R, ceil(T/2), H) in x_proj's dtype. The GRU
output never goes to device memory.

CUDA kernels. bfloat16 at H = 256: the cluster kernel of
``csrc/gru_cluster.cuh`` with its fused downsample epilogue: an 8-CTA
cluster takes 8 or 16 rows, CTA k keeps the W_hh columns of hidden units
[32k, 32k + 32) resident in registers and the W_d columns of output
channels [32k, 32k + 32) in shared memory, runs the GRU step and the conv
taps of the previous frame on ``wgmma`` (the carry split into two bf16
halves), sends its slice of the new h to the other SMs through
distributed shared memory, sums each output's taps in
shared memory and reduces the LayerNorm statistics over the cluster (route
and tiling: ``ops/gru_cluster.py``). float32 at H = 256: the same cluster
design in exact f32 on the CUDA cores (``csrc/gru_cluster_f32.cuh``): 2,
4, 8 or 9 rows a cluster, W_hh's columns in registers, W_d's 160 KB in
shared memory, the step and the conv as FFMA, h exchanged in f32, each
frame's conv run after the step's send so that it fills the exchange's
latency. Other H: ``csrc/gru_downsample.cu`` ``gru_ds_kernel``, one block
of 3H threads per sequence: thread j owns gate column j of ``h @ W_hh``,
the hidden state lives in shared memory, and every 24 steps the block runs
the downsample for the 12 outputs those steps complete from a ring of the
last 28 hidden states, then LayerNorm and GELU (``erff``) per output row.
The launch ledger (``ops/_build.py``) counts the launches of each kernel
under ``"gru_downsample"``.

Bound on the card: neither bytes nor operations, but the 2000 dependent
steps per 20 s chunk. In the block kernel W_hh (256 x 768: 768 KB in f32,
384 KB in bf16) does not fit one SM's 227 KB of shared memory, so each
step streams it from L2; the bf16 cluster kernel's step is the latency of
its chained products, the gate math and the exchange between SMs, the f32
one's the FFMA of its product (N x 256 x 96 a CTA) and the exchange.

The JAX kernel applies GELU outside (Mosaic has no erf); this kernel
rounds the LayerNorm output to the I/O dtype and applies GELU to it, as
the unfused path does. ``gru_downsample_reference`` is the plain PyTorch
version with the kernel's precision (f32 carry); the wrapper takes it only
for CPU tensors. The kernel has no backward: on a CUDA input that requires
grad, with grad enabled, the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from voiceactivityprojection_tpu_torch.ops import _build, gru_cluster
from voiceactivityprojection_tpu_torch.ops.conv import causal_conv1d, layer_norm
from voiceactivityprojection_tpu_torch.ops.gru import gru_gates

DOWNSAMPLE_KERNEL = 5
DOWNSAMPLE_STRIDE = 2
MAX_HIDDEN = 256  # 3H threads per block, at most 768
_build.declare_kernels("gru_downsample", gru_cluster.KERNELS)


def gru_downsample_reference(
    x_proj: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    h0: torch.Tensor,
    w_d: torch.Tensor,
    b_d: torch.Tensor,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
) -> torch.Tensor:
    """Plain version: GRU (f32 carry) + causal downsample + LN + GELU."""
    f = lambda t: t.to(torch.promote_types(t.dtype, torch.float32))
    xp, whh, bhh = f(x_proj), f(w_hh), f(b_hh)
    h = f(h0)
    ys = []
    for t in range(xp.shape[1]):
        h = gru_gates(xp[:, t], h, whh, bhh)
        ys.append(h)
    y = causal_conv1d(torch.stack(ys, dim=1), f(w_d), f(b_d), stride=DOWNSAMPLE_STRIDE)
    y = layer_norm(y, f(ln_w), f(ln_b)).to(x_proj.dtype)
    return F.gelu(f(y)).to(x_proj.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("gru_downsample")
    fn = lib.vap_gru_downsample
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("vap_gru_downsample_cluster", "vap_gru_downsample_cluster_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


# the cluster kernel of each dtype: its C entry and the entry of its tiling query
CLUSTER_ENTRIES = {
    torch.bfloat16: ("vap_gru_downsample_cluster", "vap_gru_downsample_cluster_info"),
    torch.float32: ("vap_gru_downsample_cluster_f32", "vap_gru_downsample_cluster_f32_info"),
}


def fused_tiling(rows: int, hidden: int, dtype: torch.dtype) -> gru_cluster.Tiling:
    """K2's route and tiling on the card (``gru_cluster.tiling``)."""
    if dtype not in CLUSTER_ENTRIES:
        return gru_cluster.Tiling("block", tiles=rows)
    info = CLUSTER_ENTRIES[dtype][1]
    return gru_cluster.tiling(rows, hidden, dtype, True, gru_cluster.card_max_clusters(_lib(), info))


def gru_downsample_fused(
    x_proj: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    h0: torch.Tensor,
    w_d: torch.Tensor,
    b_d: torch.Tensor,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
) -> torch.Tensor:
    """x_proj: (R, T, 3H) -> (R, ceil(T/2), H) 50 Hz features."""
    R, T, three_h = x_proj.shape
    H = three_h // 3
    shapes = {
        "w_hh": (w_hh, (H, three_h)), "b_hh": (b_hh, (three_h,)), "h0": (h0, (R, H)),
        "w_d": (w_d, (DOWNSAMPLE_KERNEL, H, H)), "b_d": (b_d, (H,)),
        "ln_w": (ln_w, (H,)), "ln_b": (ln_b, (H,)),
    }
    for what, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"gru_downsample: {what} must be {shape}, got {tuple(t.shape)}")
    if x_proj.device.type == "cpu":
        return gru_downsample_reference(x_proj, w_hh, b_hh, h0, w_d, b_d, ln_w, ln_b)
    if three_h != 3 * H or H % 32 or not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"gru_downsample: hidden must be a multiple of 32 up to {MAX_HIDDEN}, got {H}")
    if T < 1:
        raise ValueError("gru_downsample: empty sequence")
    if _build.grad_requested(x_proj, *(t for t, _ in shapes.values())):
        raise RuntimeError(
            "gru_downsample: the kernel has no backward (nor has the JAX kernel); "
            "training takes gru + the plain downsample"
        )
    _build.check_cuda_tensor(x_proj, "gru_downsample x_proj", x_proj.dtype)
    for what, (t, _) in shapes.items():
        _build.check_cuda_tensor(t, f"gru_downsample {what}", x_proj.dtype)
    out = torch.empty(R, (T + 1) // 2, H, dtype=x_proj.dtype, device=x_proj.device)
    ptrs = [t.data_ptr() for t in (x_proj, w_hh, b_hh, h0, w_d, b_d, ln_w, ln_b, out)]
    tiling = fused_tiling(R, H, x_proj.dtype)
    if tiling.route == "cluster":
        _build.check_aligned(x_proj, "gru_downsample x_proj")
        for what, (t, _) in shapes.items():
            _build.check_aligned(t, f"gru_downsample {what}")
        entry = getattr(_lib(), CLUSTER_ENTRIES[x_proj.dtype][0])
        rc = entry(*ptrs, R, T, tiling.cluster, tiling.rows, _build.stream_handle(x_proj))
        kernel = f"cluster {x_proj.dtype}".replace("torch.", "")
    else:
        rc = _lib().vap_gru_downsample(*ptrs, R, T, H, _build.dtype_code(x_proj.dtype),
                                       _build.stream_handle(x_proj))
        kernel = "block"
    _build.check_launch(rc, "gru_downsample", kernel)
    return out
