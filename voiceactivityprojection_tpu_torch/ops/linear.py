"""The transformer's float32 projections on the card: y = x W^T in 3xTF32 (K13).

Every projection of ``models/transformer.py`` and ``ops/attention.py``
(q, k, v and the output projection of each attention site, the FFN's two
matrices, the combinator) goes through ``linear_tf32x3``. It replaces no
TPU kernel: the JAX package leaves these products to XLA. On the card
cuBLAS runs a float32 product with TF32 off on the CUDA cores, and one TF32
pass on the tensor cores is not float32; the kernel splits each operand
into two tf32 halves and sums three tensor-core products (3xTF32), the
route the port's other float32 kernels take.

CUDA kernel: ``csrc/linear_tf32x3.cu`` ``gemm_tf32x3_kernel`` (TMA ring,
one producer warp, persistent CTAs; its header has the design), and
``split_tf32_kernel``, which writes a weight's tf32 halves as they lie (the
forward's B) and transposed (dX's B). The halves, and the tensor maps the
kernel reads them through, are kept per weight group and made again when a
weight's storage or version changes (an optimizer step,
``load_state_dict``, ``copy_`` under ``no_grad``); an inference tensor has
no version, so its halves are made at every call. Several
weights given together (self-attention's q, k, v; cross-attention's k, v)
are stacked into one B: one launch computes their outputs side by side.

Autograd: ``_Linear``, whose backward runs the same kernel for dX = dY W
(W^T's halves) and dW = dY^T X (dY and X streamed as they lie, X
transposed and split in shared memory, the rows cut into slices that
``slice_sum_kernel`` adds in a fixed order). Every launch adds each
32-deep chunk's products into a float32 sum. Without autograd the FFN's GELU and a
residual add run in the kernel's epilogue; under autograd they stay
PyTorch operations after it (GELU's backward needs its input).

Dispatch, on what the input shows and nothing else: a float32 CUDA tensor
takes the kernel; a bfloat16 one ``torch.matmul`` (cuBLAS bf16 runs on the
tensor cores at their full rate); a CPU tensor the plain version,
``linear_reference``. On the card a width the kernel does not take (input
and output widths must be multiples of 64) raises.

The launch ledger (``ops/_build.py``) counts each kernel's launches under
``"linear"``: the GEMMs (forward, dX and dW), and apart from them the
splits and the slice sums.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from voiceactivityprojection_tpu_torch.ops import _build

Weights = Union[torch.Tensor, Sequence[torch.Tensor]]

# the kernel's variants (csrc/linear_tf32x3.cu V0 .. V3) by the output
# width's tile (128 columns, or 64 for a width of 64 x odd), 128 rows a tile
WIDTH_ALIGN = 64
FORWARD_VARIANT = {128: 0, 64: 1}
WEIGHT_GRAD_VARIANT = {128: 2, 64: 3}
TILE_ROWS = 128
_build.declare_kernels("linear", ("gemm 3xtf32",), ("split tf32", "slice sum"))


def linear_reference(x: torch.Tensor, w: torch.Tensor, gelu: bool = False,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``x @ w.T``, then the exact GELU, then
    ``residual +``."""
    y = x @ w.T
    if gelu:
        y = F.gelu(y)
    return y if residual is None else residual + y


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("linear_tf32x3")
    fn = lib.vap_linear_gemm
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.vap_linear_split
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    fn = lib.vap_linear_slice_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _split(ws: Sequence[torch.Tensor], halves: torch.Tensor, halves_t: torch.Tensor) -> ctypes.Array:
    """The split kernel over up to three row-stacked (rows, K) weights:
    their tf32 halves into ``halves`` (2, N, K) and ``halves_t`` (2, K, N).
    Returns the four tensor maps the GEMM reads them through (``_Halves``)."""
    ptrs = [w.data_ptr() for w in ws] + [None] * (3 - len(ws))
    rows = [w.shape[0] for w in ws] + [0] * (3 - len(ws))
    maps = ctypes.create_string_buffer(4 * _MAP_BYTES)
    rc = _lib().vap_linear_split(*ptrs, *rows, ws[0].shape[1], halves.data_ptr(), halves_t.data_ptr(), maps,
                                 _build.stream_handle(ws[0]))
    _build.check_launch(rc, "linear", "split tf32")
    return maps


_MAP_BYTES = 128  # a CUtensorMap


class _Halves:
    """A weight group's tf32 halves, (2, N, K) as they lie (the forward's
    B) and (2, K, N) transposed (dX's B), and the addresses of the two
    tensor maps the kernel reads each through (``_split``'s)."""

    __slots__ = ("fwd", "bwd", "fwd_maps", "bwd_maps", "_buf")

    def __init__(self, fwd: torch.Tensor, bwd: torch.Tensor, maps: Optional[ctypes.Array]):
        self.fwd, self.bwd, self._buf = fwd, bwd, maps
        base = None if maps is None else ctypes.addressof(maps)
        self.fwd_maps = base
        self.bwd_maps = None if base is None else base + 2 * _MAP_BYTES


# weight group (the id of its one tensor, or the ids of its tensors) -> (weak
# references, (storage, version) of each, its _Halves)
_HALVES: Dict[Tuple[int, ...], tuple] = {}


def _check_weights(ws: Sequence[torch.Tensor]) -> None:
    for w in ws:
        _build.check_cuda_tensor(w, "linear_tf32x3 w", torch.float32)
        _build.check_aligned(w, "linear_tf32x3 w")
        if w.device != ws[0].device:
            raise ValueError(f"linear_tf32x3: weights on {w.device} and {ws[0].device}")


def _weight_group(ws: Sequence[torch.Tensor]) -> _Halves:
    """The tf32 halves of the rows of ``ws`` stacked, made again when a
    weight changed (an inference tensor has no version: its halves, and
    their maps, are made at every call)."""
    if len(ws) == 1:  # most calls: a key and a stamp without generators
        w = ws[0]
        key, tracked = id(w), not w.is_inference()
        stamp = (w.data_ptr(), w._version) if tracked else None
        hit = _HALVES.get(key)
        if hit is not None and hit[1] == stamp and hit[0][0]() is w:
            return hit[2]
    else:
        key = tuple(id(w) for w in ws)
        tracked = not any(w.is_inference() for w in ws)
        stamp = tuple((w.data_ptr(), w._version) for w in ws) if tracked else None
        hit = _HALVES.get(key)
        if hit is not None and hit[1] == stamp and all(r() is w for r, w in zip(hit[0], ws)):
            return hit[2]
    _check_weights(ws)  # once a weight version
    N, K = sum(w.shape[0] for w in ws), ws[0].shape[1]
    fwd = torch.empty(2, N, K, dtype=torch.float32, device=ws[0].device)
    bwd = torch.empty(2, K, N, dtype=torch.float32, device=ws[0].device)
    halves = _Halves(fwd, bwd, _split(ws, fwd, bwd))
    if tracked:
        for k in [k for k, v in _HALVES.items() if any(r() is None for r in v[0])]:
            del _HALVES[k]
        _HALVES[key] = (tuple(weakref.ref(w) for w in ws), stamp, halves)
    return halves


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    """The card's SMs: the persistent grid of every launch (the kernel's own
    reckoning, csrc/linear_tf32x3.cu ``sm_count``)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gemm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, M: int, N: int, kdim: int, *, variant: int,
          wgrad: bool = False, gelu: bool = False, residual: Optional[torch.Tensor] = None,
          slices: int = 1, slice_chunks: int = 0, b_maps: Optional[int] = None) -> None:
    """out (M, N) [slices of it] = A B^T: A (M, kdim) row-major (any leading
    dims, contiguous) and b
    (2, N, kdim) B's halves, read through their tensor maps at ``b_maps``
    (``_Halves``); with ``wgrad`` A and B the (kdim, M) and (kdim, N)
    matrices a and b as they lie."""
    rc = _lib().vap_linear_gemm(
        a.data_ptr(), int(wgrad), a.shape[-1], b.data_ptr() if wgrad else None, b.shape[-1], b_maps,
        out.data_ptr(),
        residual.data_ptr() if residual is not None else None, M, N, kdim, out.shape[-1], int(gelu), slices,
        slice_chunks or -(-kdim // 32), variant, _build.stream_handle(a),
    )
    _build.check_launch(rc, "linear", "gemm 3xtf32")


def tile_width(n: int) -> int:
    return 128 if n % 128 == 0 else 64


def _project(x: torch.Tensor, ws: Sequence[torch.Tensor], gelu: bool = False,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) -> (..., N), x and residual contiguous: the forward launch."""
    halves = _weight_group(ws)
    fwd = halves.fwd
    K = x.shape[-1]
    N = fwd.shape[1]
    out = torch.empty(x.shape[:-1] + (N,), dtype=torch.float32, device=x.device)
    _gemm(x, fwd, out, x.numel() // K, N, K, variant=FORWARD_VARIANT[tile_width(N)], gelu=gelu, residual=residual,
          b_maps=halves.fwd_maps)
    return out


def _input_grad(g: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """dX = dY W: g (M, N) -> (M, K), B = W^T's halves."""
    halves = _weight_group(ws)
    bwd = halves.bwd
    M, N = g.shape
    K = bwd.shape[1]
    out = torch.empty(M, K, dtype=torch.float32, device=g.device)
    _gemm(g, bwd, out, M, K, N, variant=FORWARD_VARIANT[tile_width(K)], b_maps=halves.bwd_maps)
    return out


def weight_grad_slices(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """(slices, 32-row chunks a slice) of dW's M-row contraction: about one
    CTA a SM over the (N / 128) x (K / BN) output tiles, no slice empty."""
    chunks = -(-M // 32)
    tiles = -(-N // TILE_ROWS) * (K // tile_width(K))
    slices = max(1, min(chunks, sms // tiles))
    per = -(-chunks // slices)
    return -(-chunks // per), per


def _weight_grad(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dW = dY^T X: g (M, N), x (M, K) -> (N, K)."""
    M, N = g.shape
    K = x.shape[1]
    slices, per = weight_grad_slices(M, N, K, _sm_count(x.device.index))
    dw = torch.empty(N, K, dtype=torch.float32, device=x.device)
    part = dw if slices == 1 else torch.empty(slices, N, K, dtype=torch.float32, device=x.device)
    _gemm(g, x, part, N, K, M, variant=WEIGHT_GRAD_VARIANT[tile_width(K)], wgrad=True, slices=slices,
          slice_chunks=per)
    if slices > 1:
        rc = _lib().vap_linear_slice_sum(part.data_ptr(), dw.data_ptr(), N * K, slices, _build.stream_handle(dw))
        _build.check_launch(rc, "linear", "slice sum")
    return dw


class _Linear(torch.autograd.Function):
    """The kernel forward; the backward's dX and dW on the same kernel."""

    @staticmethod
    def forward(ctx, x, *ws):
        ctx.save_for_backward(x, *ws)
        return _project(x, ws)

    @staticmethod
    def backward(ctx, g):
        x, *ws = ctx.saved_tensors
        g = g.contiguous()
        dx = _input_grad(g, ws) if ctx.needs_input_grad[0] else None
        dws = [None] * len(ws)
        if any(ctx.needs_input_grad[1:]):
            dws = list(_weight_grad(g, x).split([w.shape[0] for w in ws]))
        return (dx, *dws)


def check_shapes(x_shape: Sequence[int], N: int, residual_shape: Optional[Sequence[int]] = None) -> None:
    """Raise unless the kernel takes x (..., K) -> (..., N), and the
    residual, if any, has the output's shape."""
    K = x_shape[-1]
    if K % WIDTH_ALIGN or N % WIDTH_ALIGN:
        raise ValueError(f"linear_tf32x3: the kernel takes input and output widths that are multiples of "
                         f"{WIDTH_ALIGN}, got {K} -> {N}")
    if residual_shape is not None and tuple(residual_shape) != (*x_shape[:-1], N):
        raise ValueError(f"linear_tf32x3: residual must be {(*x_shape[:-1], N)}, got {tuple(residual_shape)}")


def linear_tf32x3(x: torch.Tensor, w: Weights, gelu: bool = False,
                  residual: Optional[torch.Tensor] = None) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``x @ w.T`` (then the exact GELU, then ``residual +``): x (..., K),
    w (N, K) -> (..., N). A sequence of weights (N_i, K) gives the tuple of
    their outputs (..., N_i), from one launch on the card. Differentiable in
    x, w and residual on either device."""
    several = isinstance(w, (tuple, list))
    ws = tuple(w) if several else (w,)
    K = x.shape[-1]
    for wi in ws:
        if wi.ndim != 2 or wi.shape[1] != K:
            raise ValueError(f"linear_tf32x3: w must be (N, {K}), got {[tuple(wi.shape) for wi in ws]}")
    if residual is not None and len(ws) > 1:
        raise ValueError("linear_tf32x3: a residual goes with one weight")
    if x.device.type == "cpu" or x.dtype != torch.float32:
        outs = tuple(linear_reference(x, wi, gelu, residual) for wi in ws)
        return outs if several else outs[0]
    N = ws[0].shape[0] if len(ws) == 1 else sum(wi.shape[0] for wi in ws)
    check_shapes(x.shape, N, None if residual is None else residual.shape)
    if ws[0].device != x.device:
        raise ValueError(f"linear_tf32x3: w on {ws[0].device}, x on {x.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    _build.check_aligned(x, "linear_tf32x3 x")
    if residual is not None and not residual.is_contiguous():
        residual = residual.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or any(wi.requires_grad for wi in ws)
                                    or (residual is not None and residual.requires_grad)):
        y = _Linear.apply(x.reshape(-1, K), *ws)
        if gelu:
            y = F.gelu(y)
        y = y.reshape(x.shape[:-1] + (N,))
        if residual is not None:
            y = residual + y
    else:
        if residual is not None:
            _build.check_aligned(residual, "linear_tf32x3 residual")
        y = _project(x, ws, gelu, residual)
    return tuple(y.split([wi.shape[0] for wi in ws], dim=-1)) if several else y
