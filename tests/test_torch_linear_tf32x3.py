"""PyTorch port: the transformer's float32 projections (``ops/linear.py``
``linear_tf32x3``, K13, ``csrc/linear_tf32x3.cu``).

On the CPU: the wrapper's plain route is ``x @ w.T`` (then the exact GELU,
then the residual) at the port's widths and the tensor-parallel shards,
and several weights give the tuple of their products; the widths the
kernel refuses; the autograd function's wiring (dX, and dW split back
into each weight's rows) against autograd of the plain product in
float64, with the kernel's launches replaced by plain products; the
weights' halves, and the tensor maps the split encodes beside them,
kept until a weight's storage or version changes, the forward and dX
each reading its own halves' maps; dW's slices; the kernel's arithmetic (tf32 halves, three products, each
32-deep chunk promoted into a float32 sum) emulated, against float64 and
against one TF32 pass.

On the card (marked ``cuda``; they skip without one): forward, dX and dW
at the inference and frozen-training shapes against a float64 product,
each within its bar and at least 10x closer than one ``allow_tf32`` pass;
the exact launches of one ``VapModel.probs`` call and none in a
``BatchedKVStreamer`` tick; an optimizer step's in-place update reaching
the next forward. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_linear_tf32x3.py
"""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import linear as lin
from voiceactivityprojection_tpu_torch.ops.linear import linear_reference, linear_tf32x3

pytestmark = pytest.mark.transformer

# (K, N): the port's projections at dim 256 (q/k/v, the stacked q/k/v and
# cross k/v, the output projection, the FFN, the combinator) and the
# tensor-parallel shards of 2 and 4 model ranks
WIDTHS = [(256, 256), (256, 768), (256, 512), (768, 256), (256, 128), (128, 256), (256, 384), (384, 256),
          (256, 64), (64, 256), (256, 192), (192, 256)]
# the card's bar: the largest gap from the float64 product over the
# largest output (K13 reads 3.0-4.4e-7 at every shape timed; cuBLAS in
# FFMA 2.0e-7-1.4e-6; one TF32 pass 2.6e-4-3.7e-4)
CARD_REL = 2e-6


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


# ---------------------------------------------------------------- the CPU --
@pytest.mark.parametrize("K,N", WIDTHS)
def test_plain_route_is_the_product(K, N):
    g = torch.Generator().manual_seed(K + N)
    x = torch.randn(3, 17, K, generator=g)
    w = torch.randn(N, K, generator=g) * 0.05
    r = torch.randn(3, 17, N, generator=g)
    assert torch.equal(linear_tf32x3(x, w), x @ w.T)
    assert torch.equal(linear_tf32x3(x, w, gelu=True), F.gelu(x @ w.T))
    assert torch.equal(linear_tf32x3(x, w, residual=r), r + x @ w.T)
    assert torch.equal(linear_reference(x, w, True, r), r + F.gelu(x @ w.T))


@pytest.mark.parametrize("sizes", [(256, 256, 256), (256, 256), (128, 128, 128), (64,)])
def test_several_weights_give_their_products(sizes):
    g = torch.Generator().manual_seed(len(sizes))
    x = torch.randn(2, 9, 256, generator=g)
    ws = tuple(torch.randn(n, 256, generator=g) for n in sizes)
    outs = linear_tf32x3(x, ws)
    assert isinstance(outs, tuple) and len(outs) == len(ws)
    for o, w in zip(outs, ws):
        assert torch.equal(o, x @ w.T)


def test_bfloat16_takes_torch_matmul():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 256, generator=g).bfloat16()
    w = torch.randn(128, 256, generator=g).bfloat16()
    assert torch.equal(linear_tf32x3(x, w), x @ w.T)


@pytest.mark.parametrize("bad", ["w width", "residual with several", "residual shape", "weights off the card"])
def test_refusals_on_any_device(bad):
    x, w = torch.zeros(2, 5, 256), torch.zeros(128, 256)
    with pytest.raises(ValueError):
        if bad == "w width":
            linear_tf32x3(x, torch.zeros(128, 255))
        elif bad == "residual with several":
            linear_tf32x3(x, (w, w), residual=torch.zeros(2, 5, 128))
        elif bad == "residual shape":
            lin.check_shapes(x.shape, 128, (2, 5, 127))
        else:
            lin._check_weights([w])  # the kernel route's check of its weights


@pytest.mark.parametrize("K,N", [(255, 256), (256, 96), (32, 256), (256, 32), (100, 100)])
def test_the_kernel_refuses_widths_off_its_tiles(K, N):
    with pytest.raises(ValueError, match="multiples of 64"):
        lin.check_shapes((4, K), N)


@pytest.mark.parametrize("K,N", WIDTHS)
def test_the_kernel_takes_every_width_of_the_port(K, N):
    lin.check_shapes((4, 7, K), N, (4, 7, N))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_adds_the_residual_as_the_layer_did(impl, cross):
    from voiceactivityprojection_tpu_torch.ops.attention import MHA, attention

    g = torch.Generator().manual_seed(7 + cross)
    p = MHA(64, 4)
    for name in ("query", "key", "value", "proj"):
        getattr(p, name).w.data = torch.randn(64, 64, generator=g) * 0.1
    z, src, r = (torch.randn(2, 9, 64, generator=g) for _ in range(3))
    kv = src if cross else z
    with torch.no_grad():
        out, _ = attention(p, z, kv, 4, impl=impl)
        fused, _ = attention(p, z, kv, 4, impl=impl, residual=r)
    assert torch.equal(fused, r + out)


def _plain_kernels(monkeypatch):
    """The autograd function's three launches as plain products, in the
    inputs' dtype."""
    monkeypatch.setattr(lin, "_project", lambda x, ws, gelu=False, residual=None: x @ torch.cat(ws).T)
    monkeypatch.setattr(lin, "_input_grad", lambda g, ws: g @ torch.cat(ws))
    monkeypatch.setattr(lin, "_weight_grad", lambda g, x: g.T @ x)


@pytest.mark.parametrize("sizes", [(256,), (256, 256, 256), (128, 256)])
@pytest.mark.parametrize("grad_x", [True, False])
def test_autograd_function_against_the_plain_product_in_float64(monkeypatch, sizes, grad_x):
    _plain_kernels(monkeypatch)
    g = torch.Generator().manual_seed(sum(sizes) + grad_x)
    x = torch.randn(37, 256, generator=g, dtype=torch.float64, requires_grad=grad_x)
    ws = [torch.randn(n, 256, generator=g, dtype=torch.float64, requires_grad=True) for n in sizes]
    gy = torch.randn(37, sum(sizes), generator=g, dtype=torch.float64)
    y = lin._Linear.apply(x, *ws)
    got = torch.autograd.grad(y, ([x] if grad_x else []) + ws, gy)
    want_y = torch.cat([x @ w.T for w in ws], dim=-1)
    want = torch.autograd.grad(want_y, ([x] if grad_x else []) + ws, gy)
    assert torch.allclose(y, want_y, rtol=0, atol=1e-12)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.allclose(a, b, rtol=0, atol=1e-10)


def _plain_split(calls):
    @torch.no_grad()  # the kernel writes through pointers: the halves hold no graph of the weights
    def split(ws, halves, halves_t):
        calls.append(len(ws))
        w = torch.cat(ws)
        halves.copy_(torch.stack([w, torch.zeros_like(w)]))
        halves_t.copy_(torch.stack([w.T, torch.zeros_like(w.T)]))
    return split


def test_halves_are_kept_until_a_weight_changes(monkeypatch):
    calls = []
    monkeypatch.setattr(lin, "_split", _plain_split(calls))
    monkeypatch.setattr(lin, "_check_weights", lambda ws: None)  # the card's checks
    monkeypatch.setattr(lin, "_HALVES", {})
    ws = [torch.nn.Parameter(torch.randn(64, 32)) for _ in range(3)]
    halves = lin._weight_group(ws)
    fwd, bwd = halves.fwd, halves.bwd
    assert calls == [3] and torch.equal(fwd[0], torch.cat(ws).detach())
    assert torch.equal(bwd[0], torch.cat(ws).detach().T)
    assert lin._weight_group(ws).fwd is fwd and calls == [3]  # kept
    opt = torch.optim.AdamW(ws, lr=0.1)
    for w in ws:
        w.grad = torch.ones_like(w)
    opt.step()  # in place: the versions move
    fwd2 = lin._weight_group(ws).fwd
    assert calls == [3, 3] and torch.equal(fwd2[0], torch.cat(ws).detach())
    with torch.no_grad():
        ws[2].copy_(torch.zeros(64, 32))  # load_state_dict's way
    assert torch.equal(lin._weight_group(ws).fwd[0, 128:], torch.zeros(64, 32)) and len(calls) == 3
    ws[0].data = torch.ones(64, 32)  # new storage
    assert torch.equal(lin._weight_group(ws).fwd[0, :64], torch.ones(64, 32)) and len(calls) == 4
    other = [torch.nn.Parameter(torch.randn(64, 32))]
    lin._weight_group(other)
    assert len(calls) == 5 and len(lin._HALVES) == 2
    del other
    lin._weight_group(ws[:1])  # a miss drops the groups whose weights are gone
    assert len(lin._HALVES) == 2


def test_inference_tensors_split_at_every_call(monkeypatch):
    calls = []
    monkeypatch.setattr(lin, "_split", _plain_split(calls))
    monkeypatch.setattr(lin, "_check_weights", lambda ws: None)
    monkeypatch.setattr(lin, "_HALVES", {})
    with torch.inference_mode():
        w = torch.randn(64, 32)
        lin._weight_group([w])
        lin._weight_group([w])
    assert calls == [1, 1] and lin._HALVES == {}


def test_the_split_keeps_its_tensor_maps_beside_the_halves(monkeypatch):
    bufs = []

    def split(ws, halves, halves_t):
        bufs.append(ctypes.create_string_buffer(4 * lin._MAP_BYTES))
        return bufs[-1]
    monkeypatch.setattr(lin, "_split", split)
    monkeypatch.setattr(lin, "_check_weights", lambda ws: None)
    monkeypatch.setattr(lin, "_HALVES", {})
    ws = [torch.nn.Parameter(torch.randn(128, 64)) for _ in range(3)]
    halves = lin._weight_group(ws)
    base = ctypes.addressof(bufs[0])
    assert halves.fwd_maps == base and halves.bwd_maps == base + 2 * lin._MAP_BYTES
    assert lin._weight_group(ws) is halves and len(bufs) == 1  # kept with the halves
    with torch.no_grad():
        ws[1].add_(1.0)
    again = lin._weight_group(ws)
    assert len(bufs) == 2 and again.fwd_maps == ctypes.addressof(bufs[1])  # made again with them
    assert lin._Halves(halves.fwd, halves.bwd, None).bwd_maps is None  # encoded at each launch


@pytest.mark.parametrize("N,K", [(768, 256), (256, 768), (192, 256)])
def test_forward_and_dx_read_their_own_halves_maps(monkeypatch, N, K):
    buf = ctypes.create_string_buffer(4 * lin._MAP_BYTES)
    halves = lin._Halves(torch.zeros(2, N, K), torch.zeros(2, K, N), buf)
    seen = []
    monkeypatch.setattr(lin, "_weight_group", lambda ws: halves)
    monkeypatch.setattr(lin, "_gemm", lambda a, b, out, M, n, kdim, **kw: seen.append((b, n, kdim, kw)))
    w = torch.zeros(N, K)
    lin._project(torch.zeros(32, K), [w])
    lin._input_grad(torch.zeros(32, N), [w])
    (bf, nf, kf, kwf), (bd, nd, kd, kwd) = seen
    assert bf is halves.fwd and (nf, kf) == (N, K) and kwf["b_maps"] == halves.fwd_maps
    assert kwf["variant"] == lin.FORWARD_VARIANT[lin.tile_width(N)]
    assert bd is halves.bwd and (nd, kd) == (K, N) and kwd["b_maps"] == halves.bwd_maps
    assert kwd["variant"] == lin.FORWARD_VARIANT[lin.tile_width(K)]


@pytest.mark.parametrize("M", [1000, 16000, 32000, 64000, 128000, 7, 33])
@pytest.mark.parametrize("N,K", [(768, 256), (256, 256), (512, 256), (256, 768), (64, 256), (128, 192)])
def test_weight_grad_slices_cover_the_rows_once(M, N, K):
    sms = 132
    slices, per = lin.weight_grad_slices(M, N, K, sms)
    chunks = -(-M // 32)
    assert slices >= 1 and per >= 1
    assert (slices - 1) * per < chunks <= slices * per  # no slice empty, every chunk in one
    tiles = -(-N // lin.TILE_ROWS) * (K // lin.tile_width(K))
    assert slices * tiles <= max(sms, tiles)


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """v rounded to tf32, nearest with ties away from zero (``cvt.rna.tf32.f32``)."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K13's arithmetic in float32: each operand split into tf32 halves,
    x_lo w_hi + x_hi w_lo + x_hi w_hi a 32-deep chunk (products exact, the
    chunk's sum in float32), each chunk added to the running float32 sum."""
    xh = _tf32(x)
    xl = _tf32(x - xh)
    wh = _tf32(w)
    wl = _tf32(w - wh)
    acc = torch.zeros(x.shape[0], w.shape[0])
    for c in range(0, x.shape[1], 32):
        s = slice(c, c + 32)
        part = (xl[:, s].double() @ wh[:, s].double().T + xh[:, s].double() @ wl[:, s].double().T
                + xh[:, s].double() @ wh[:, s].double().T).float()
        acc = acc + part
    return acc


def test_tf32_rounding_keeps_ten_mantissa_bits():
    v = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -1.0 - 2**-11, 2**-20 * 1.337], dtype=torch.float32)
    t = _tf32(v)  # ties away from zero, both signs
    assert t[0] == 1.0 and t[1] == 1.0 + 2**-10 and t[2] == 1.0 + 2**-10 and t[3] == -1.0 - 2**-10
    assert (t.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float((v - t).abs().max() / v.abs().max()) <= 2**-11


@pytest.mark.parametrize("K", [256, 768])
def test_emulated_arithmetic_is_float32_and_one_tf32_pass_is_not(K):
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.standard_normal((64, K)).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.standard_normal((128, K))).astype(np.float32))
    ref = x.double() @ w.double().T
    got = _rel(_emulate(x, w), ref)
    one_pass = _rel(_tf32(x).double() @ _tf32(w).double().T, ref)
    plain = _rel(x @ w.T, ref)
    assert got < 1e-6 and got < 3 * plain + 1e-7
    assert one_pass > 1e-4 and got * 10 < one_pass


# --------------------------------------------------------------- the card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel compiles and runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tf32_pass(fn):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(64000, 256, 768), (64000, 256, 256), (64000, 768, 256), (64000, 256, 512),
                                   (1000, 256, 768), (4860, 256, 256), (64000, 256, 192)])
def test_forward_on_the_card_against_float64(cuda, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, device=cuda, generator=g)
    w = torch.randn(N, K, device=cuda, generator=g) * 0.05
    ref = x.double() @ w.double().T
    err = _rel(linear_tf32x3(x, w), ref)
    tf32 = _rel(_tf32_pass(lambda: x @ w.T), ref)
    assert err <= CARD_REL and err * 10 <= tf32, (err, tf32)
    r = torch.randn(M, N, device=cuda, generator=g)
    assert _rel(linear_tf32x3(x, w, gelu=True), F.gelu(ref)) <= CARD_REL
    assert _rel(linear_tf32x3(x, w, residual=r), r.double() + ref) <= CARD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(16000, 256, 768), (16000, 256, 256), (16000, 768, 256), (16000, 256, 512),
                                   (16000, 256, 64), (1000, 192, 128)])
def test_backward_on_the_card_against_float64(cuda, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, device=cuda, generator=g, requires_grad=True)
    w = (torch.randn(N, K, device=cuda, generator=g) * 0.05).requires_grad_()
    gy = torch.randn(M, N, device=cuda, generator=g)
    dx, dw = torch.autograd.grad(linear_tf32x3(x, w), (x, w), gy)
    g64 = gy.double()
    want_dx, want_dw = g64 @ w.double(), g64.T @ x.double()
    tf32_dx, tf32_dw = _tf32_pass(lambda: (gy @ w, gy.T @ x))
    for got, want, one_pass in ((dx, want_dx, tf32_dx), (dw, want_dw, tf32_dw)):
        err, tf32 = _rel(got, want), _rel(one_pass, want)
        assert err <= CARD_REL and err * 10 <= tf32, (err, tf32)


@pytest.mark.cuda
def test_the_stacked_weights_and_the_dw_slices_match_one_by_one(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(3000, 256, device=cuda, generator=g, requires_grad=True)
    ws = [(torch.randn(256, 256, device=cuda, generator=g) * 0.05).requires_grad_() for _ in range(3)]
    outs = linear_tf32x3(x, tuple(ws))
    gys = [torch.randn(3000, 256, device=cuda, generator=g) for _ in ws]
    grads = torch.autograd.grad(outs, [x] + ws, gys)
    for o, w in zip(outs, ws):
        assert torch.equal(o, linear_tf32x3(x.detach(), w.detach()))
    want = [sum(gy.double() @ w.double() for gy, w in zip(gys, ws))] + [gy.double().T @ x.double() for gy in gys]
    for got, ref in zip(grads, want):
        assert _rel(got, ref) <= CARD_REL
    again = torch.autograd.grad(linear_tf32x3(x, tuple(ws)), [x] + ws, gys)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # the slices add in a fixed order


@pytest.mark.cuda
def test_an_optimizer_step_reaches_the_next_forward(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2000, 256, device=cuda, generator=g)
    w = torch.nn.Parameter(torch.randn(768, 256, device=cuda, generator=g) * 0.05)
    opt = torch.optim.AdamW([w], lr=0.05)
    for _ in range(3):
        y = linear_tf32x3(x, w)
        assert _rel(y, x.double() @ w.detach().double().T) <= CARD_REL
        opt.zero_grad()
        y.square().mean().backward()
        opt.step()  # in place: the next forward must see the new weights
    with torch.no_grad():
        w.mul_(-2.0)
        assert _rel(linear_tf32x3(x, w), x.double() @ w.double().T) <= CARD_REL


@pytest.mark.cuda
def test_launches_of_one_probs_call_and_none_in_a_kv_tick(cuda):
    from voiceactivityprojection_tpu_torch.config import VapConfig
    from voiceactivityprojection_tpu_torch.inference.streaming_kv import BatchedKVStreamer
    from voiceactivityprojection_tpu_torch.models.vap import VapModel

    model = VapModel(VapConfig(), device="cuda")
    conf = model.conf
    rng = np.random.default_rng(0)
    wave = torch.from_numpy((0.1 * rng.standard_normal((2, 2, 16000))).astype(np.float32)).to(cuda)
    model.probs(wave)  # the weights' halves are made in the first call
    before = _build.launch_counts()
    model.probs(wave)
    torch.cuda.synchronize()
    ran = _build.launches_since(before)["linear"]
    # q/k/v, output projection, FFN x 2 a channel layer and channel; q/k/v,
    # projection, cross q, cross k/v, projection, FFN x 2 a cross layer and
    # side; the combinator's two
    want = 4 * 2 * conf.channel_layers + 7 * 2 * conf.cross_layers + 2
    assert ran["gemm 3xtf32"] == want == 52
    assert ran["split tf32"] == 0
    streamer = BatchedKVStreamer(model, streams=4, context_time=0.5)
    for _ in range(4):
        before = _build.launch_counts()
        streamer.push((0.1 * rng.standard_normal((4, 2, 320))).astype(np.float32))
        torch.cuda.synchronize()
        assert _build.launch_totals(_build.launches_since(before))["linear"] == 0
