"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same inputs, and the model on the card against the same
model on the CPU. Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from voiceactivityprojection_tpu_torch import VapConfig, VapModel, params_from_jax
from voiceactivityprojection_tpu_torch.config import OptConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import random_params_tree
from voiceactivityprojection_tpu_torch.models.vap import VapNet
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import conv_fused as k11
from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
from voiceactivityprojection_tpu_torch.ops import flash_alibi as k4
from voiceactivityprojection_tpu_torch.ops import flash_alibi_train as ft
from voiceactivityprojection_tpu_torch.ops import gru_cluster as gcl
from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
from voiceactivityprojection_tpu_torch.ops import gru_recurrence as k3
from voiceactivityprojection_tpu_torch.train import step as tstep
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes

from _torch_tol import bf16_tol

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels compile and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def state():
    conf = VapConfig()
    return params_from_jax(random_params_tree(conf, seed=0), conf)


def _launched(before):
    """Each op's launches since ``before`` (``_build.launch_counts()``),
    without its auxiliary kernels."""
    return _build.launch_totals(_build.launches_since(before))


def _layers(state, device, dtype=torch.float32):
    return [
        tuple(state[f"encoder.gEncoder.{i}.{p}"].to(device, dtype)
              for p in ("conv.w", "conv.b", "norm.w", "norm.b"))
        for i in range(5)
    ]


@pytest.mark.parametrize("n", [16000, 12345, 161])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_stack_kernel_matches_plain(cuda, state, n, dtype):
    """float32 (conv0 on the CUDA cores, conv1-conv4 on the tensor cores in
    3xTF32) to 1e-4; bfloat16 (conv0 on the CUDA cores, conv1-conv4 on the
    tensor cores) to four
    roundings (each layer's output and, in the plain version, each conv
    sum, a step moving the next layer's statistics)."""
    layers = _layers(state, cuda, dtype)
    x = (0.1 * torch.randn(4, n, device=cuda)).to(dtype)
    before = _build.launch_counts()
    got = k1.fused_conv_stack(layers, x)
    torch.cuda.synchronize()
    assert _launched(before)["conv_stack"] == 5 and got.dtype == dtype
    want = k1.reference_stack(layers, x)
    tol = 1e-4 if dtype == torch.float32 else bf16_tol(want, 4)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("layer", [1, 2, 3, 4])
def test_conv_layer_kernel_matches_plain_bf16(cuda, state, layer):
    """One bfloat16 launch of each Cin = 256 layer (the tensor-core kernel)
    against ``plain_layers`` on the same post-ReLU input, R=3 x 1001 input
    frames (a ragged last tile), to two roundings."""
    spec = k1.CPC_CONV_SPECS[layer]
    lw = _layers(state, cuda, torch.bfloat16)[layer]
    gen = torch.Generator().manual_seed(layer)
    x = torch.relu(torch.randn(3, 1001, 256, generator=gen)).to(cuda, torch.bfloat16)
    got = k1.conv_cn_relu(x, lw, spec[1], spec[2])
    torch.cuda.synchronize()
    want = k1.plain_layers([lw], x, [spec])
    assert got.shape == want.shape == (3, (1001 + 2 * spec[2] - spec[0]) // spec[1] + 1, 256)
    torch.testing.assert_close(got.float(), want.float(), atol=bf16_tol(want), rtol=0)


@pytest.mark.parametrize("layer", [1, 2, 3, 4])
def test_conv_layer_kernel_matches_plain_f32(cuda, state, layer):
    """One float32 launch of each Cin = 256 layer (the 3xTF32 tensor-core
    kernel, after the split of w into K-major tf32 halves) against
    ``plain_layers`` on the same post-ReLU input, R=3 x 1001 input frames
    and R=1 x 5 (ragged tiles of 128 positions), to the float32 bar; each
    launch counted on the 3xTF32 kernel, after one split."""
    spec = k1.CPC_CONV_SPECS[layer]
    lw = _layers(state, cuda)[layer]
    gen = torch.Generator().manual_seed(layer)
    for R, n_in in ((3, 1001), (1, 5)):
        x = torch.relu(torch.randn(R, n_in, 256, generator=gen)).to(cuda)
        before = _build.launch_counts()
        got = k1.conv_cn_relu(x, lw, spec[1], spec[2])
        torch.cuda.synchronize()
        ran = _build.launches_since(before)["conv_stack"]
        assert ran == {"cuda cores": 0, "wgmma bfloat16": 0, "wgmma 3xtf32": 1, "split tf32": 1}
        want = k1.plain_layers([lw], x, [spec])
        assert got.shape == want.shape == (R, (n_in + 2 * spec[2] - spec[0]) // spec[1] + 1, 256)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_read_nothing_outside_the_input(cuda, state, dtype):
    """R=1: each layer's input is a slice of a buffer whose 64 rows before
    and after it hold NaN, and so is the stack's: every launch gives finite
    results equal to its plain version, so none reads a row outside
    [0, n_in) (the tensor-core kernel zero-fills through the copies'
    source size)."""
    layers = _layers(state, cuda, dtype)
    gen = torch.Generator().manual_seed(5)

    def nan_framed(core):
        buf = torch.full((1, core.shape[1] + 128, *core.shape[2:]), float("nan"), dtype=dtype)
        buf[:, 64:64 + core.shape[1]] = core.to(dtype)
        view = buf.to(cuda)[:, 64:64 + core.shape[1]]
        assert view.is_contiguous()
        return view

    x = nan_framed(0.1 * torch.randn(1, 3041, generator=gen))
    pairs = [(k1.fused_conv_stack(layers, x), k1.reference_stack(layers, x), 4)]
    for i, spec in enumerate(k1.CPC_CONV_SPECS):
        z = nan_framed(torch.relu(torch.randn(1, 301, 256, generator=gen))) if i else x
        pairs.append((k1.conv_cn_relu(z, layers[i], spec[1], spec[2]),
                      k1.plain_layers([layers[i]], z if i else z[..., None], [spec]), 2))
    torch.cuda.synchronize()
    for got, want, steps in pairs:
        assert bool(torch.isfinite(got).all())
        tol = 1e-4 if dtype == torch.float32 else bf16_tol(want, steps)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def _gru_args(state, R, T, device, dtype=torch.float32):
    g = {k: state[f"encoder.gAR.{k}"] for k in ("w_hh", "b_hh")}
    d = {k: state[f"encoder.downsample.{k}"] for k in ("conv.w", "conv.b", "ln.w", "ln.b")}
    x_proj = 0.5 * torch.randn(R, T, 768)
    args = [x_proj, g["w_hh"], g["b_hh"], torch.zeros(R, 256), d["conv.w"], d["conv.b"],
            d["ln.w"], d["ln.b"]]
    return [a.to(device, dtype).contiguous() for a in args]


@pytest.mark.parametrize("T", [1, 48, 33, 2000])
def test_gru_downsample_kernel_matches_plain(cuda, state, T):
    args = _gru_args(state, 3, T, cuda)
    got = k2.gru_downsample_fused(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, k2.gru_downsample_reference(*args), atol=5e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,T", [(3, 1), (3, 485), (8, 2000)])
def test_gru_downsample_block_kernel_matches_plain(cuda, R, T, dtype):
    """H = 128, where K2 takes the block kernel ``gru_ds_kernel`` in both
    dtypes: against the plain version, each call counted on the block
    kernel."""
    gen = torch.Generator().manual_seed(R * T)
    H = 128
    args = [0.5 * torch.randn(R, T, 3 * H, generator=gen), torch.randn(H, 3 * H, generator=gen) / 12,
            0.1 * torch.randn(3 * H, generator=gen), 0.1 * torch.randn(R, H, generator=gen),
            torch.randn(5, H, H, generator=gen) / 25, 0.1 * torch.randn(H, generator=gen),
            1 + 0.1 * torch.randn(H, generator=gen), 0.1 * torch.randn(H, generator=gen)]
    args = [a.to(cuda, dtype).contiguous() for a in args]
    assert k2.fused_tiling(R, H, dtype).route == "block"
    before = _build.launch_counts()
    got = k2.gru_downsample_fused(*args)
    torch.cuda.synchronize()
    assert _build.launches_since(before)["gru_downsample"]["block"] == 1
    want = k2.gru_downsample_reference(*args)
    atol = 5e-5 if dtype == torch.float32 else bf16_tol(want, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("T", [1000, 3000, 77, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(cuda, T, dtype, dh):
    """float32 (the 3xTF32 tensor-core kernel) to 5e-6; bfloat16 (the
    tensor-core kernel) to two roundings (p and the output); at each head
    width the kernels take (256 / dh heads)."""
    q, k, v = (torch.randn(2, 256 // dh, T, dh, device=cuda).to(dtype) for _ in range(3))
    s = alibi_slopes(256 // dh).to(cuda)
    got = k4.flash_alibi_attention(q, k, v, s, 1 / 16)
    torch.cuda.synchronize()
    want = k4.dense_reference(q, k, v, s, 1 / 16)
    assert got.dtype == dtype
    tol = 5e-6 if dtype == torch.float32 else bf16_tol(want)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def test_kernels_refuse_what_they_do_not_take(cuda, state):
    q = torch.randn(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        k4.flash_alibi_attention(q, q, q, alibi_slopes(2).to(cuda), 0.1)
    with pytest.raises(ValueError, match="head dim"):
        ft.flash_train_forward(q, q, q, alibi_slopes(2).to(cuda), 0, 0.1, 0.1)
    with pytest.raises(ValueError, match="float16"):
        q16 = torch.randn(1, 2, 8, 64, device=cuda).half()
        k4.flash_alibi_attention(q16, q16, q16, alibi_slopes(2).to(cuda), 0.1)
    x = torch.randn(2, 3200, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_conv_stack(_layers(state, cuda), x[:, ::2])
    # the tensor-core kernels copy 16-byte pieces: a bf16 view 2 bytes in
    # is refused by the inference attention, the training forward and
    # backward and the conv layers with Cin = 256, not sent to the CUDA cores
    odd = torch.randn(1 + 8 * 64, device=cuda).bfloat16()[1:].view(1, 1, 8, 64)
    s1 = alibi_slopes(1).to(cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        k4.flash_alibi_attention(odd, odd, odd, s1, 0.1)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ft.flash_train_forward(odd, odd, odd, s1, 0, 0.1, 0.1)
    lse = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ft.flash_train_backward(odd, odd, odd, s1, 0, odd, lse, odd, 0.1, 0.1)
    odd_z = torch.randn(1 + 16 * 256, device=cuda).bfloat16()[1:].view(1, 16, 256)
    with pytest.raises(ValueError, match="16-byte boundary"):
        k1.conv_cn_relu(odd_z, _layers(state, cuda, torch.bfloat16)[1], 4, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_on_card_matches_cpu(cuda, state, dtype):
    conf = VapConfig(dtype=dtype)
    wave = (0.1 * np.random.default_rng(0).standard_normal((2, 2, 16000))).astype(np.float32)
    before = _build.launch_counts()
    got = VapModel(conf, state, device="cuda").probs(wave)
    launched = _launched(before)
    assert [launched[op] for op in ("conv_stack", "gru_downsample", "flash_alibi")] == [5, 1, 14]
    want = VapModel(VapConfig(), state, device="cpu").probs(wave)
    # float32: the JAX package's bar; bfloat16 vs float32: the bf16 slice bound
    atol = 2e-4 if dtype == "float32" else 2e-3
    for key in ("p_now", "p_future"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=atol, rtol=0)
    assert math.isfinite(float(got["H"].sum()))


@pytest.mark.parametrize("T", [1, 33, 2000])
def test_gru_recurrence_kernel_matches_plain(cuda, state, T):
    args = _gru_args(state, 3, T, cuda)
    args = [args[0], args[1], args[2], 0.1 * torch.randn(3, 256, device=cuda)]
    ys, h_last = k3.gru_recurrence(*args)
    torch.cuda.synchronize()
    want, _ = k3.gru_recurrence_reference(*args)
    torch.testing.assert_close(ys, want, atol=5e-6, rtol=0)
    assert torch.equal(h_last, ys[:, -1])


def _bf16_gru_args(state, R, T, device, gen):
    """bf16 inputs of K2 / K3 with a nonzero h0 (x_proj, w_hh, b_hh, h0, and
    K2's w_d, b_d, ln_w, ln_b)."""
    args = _gru_args(state, R, T, "cpu")
    args[3] = 0.1 * torch.randn(R, 256, generator=gen)
    args[0] = 0.5 * torch.randn(R, T, 768, generator=gen)
    return [a.to(device, torch.bfloat16).contiguous() for a in args]


GRU_ROWS = [1, 2, 3, 9, 32, 128]
GRU_STEPS = [1, 33, 48, 2000]


@pytest.mark.parametrize("T", GRU_STEPS)
@pytest.mark.parametrize("R", GRU_ROWS)
def test_gru_recurrence_cluster_kernel_matches_plain_bf16(cuda, state, R, T):
    """bfloat16 at H = 256: the cluster kernel (partial tiles at R = 1, 3,
    9) against the plain version, to two bf16 roundings (its output only;
    the carry is f32 on both sides)."""
    args = _bf16_gru_args(state, R, T, cuda, torch.Generator().manual_seed(R * 7919 + T))[:4]
    assert k3.forward_tiling(R, 256, torch.bfloat16).route == "cluster"
    before = _build.launch_counts()
    ys, h_last = k3.gru_recurrence(*args)
    torch.cuda.synchronize()
    assert _launched(before)["gru_recurrence"] == 1 and ys.dtype == torch.bfloat16
    want, _ = k3.gru_recurrence_reference(*args)
    torch.testing.assert_close(ys.float(), want.float(), atol=bf16_tol(want, 2), rtol=0)
    assert torch.equal(h_last, ys[:, -1])


@pytest.mark.parametrize("T", GRU_STEPS)
@pytest.mark.parametrize("R", GRU_ROWS)
def test_gru_downsample_cluster_kernel_matches_plain_bf16(cuda, state, R, T):
    """bfloat16 at H = 256: the cluster kernel with its fused downsample,
    LayerNorm and GELU against the plain version, to two bf16 roundings
    (the LayerNorm output and the output); odd T gives ceil(T/2) outputs."""
    args = _bf16_gru_args(state, R, T, cuda, torch.Generator().manual_seed(R * 7919 + T))
    assert k2.fused_tiling(R, 256, torch.bfloat16).route == "cluster"
    before = _build.launch_counts()
    got = k2.gru_downsample_fused(*args)
    torch.cuda.synchronize()
    assert _launched(before)["gru_downsample"] == 1 and got.shape == (R, (T + 1) // 2, 256)
    want = k2.gru_downsample_reference(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=bf16_tol(want, 2), rtol=0)


F32_GRU_ROWS = [1, 2, 3, 8, 9, 17, 128]
F32_GRU_STEPS = [1, 2, 485, 1999]


@pytest.mark.parametrize("T", F32_GRU_STEPS)
@pytest.mark.parametrize("R", F32_GRU_ROWS)
def test_gru_downsample_cluster_kernel_matches_plain_f32(cuda, state, R, T):
    """float32 at H = 256: the f32 cluster kernel (2, 4, 8 or 9 rows a
    cluster, partial tiles, odd T) with its fused downsample, LayerNorm and
    GELU against the plain version at the float32 bar; a nonzero h0."""
    args = _gru_args(state, R, T, "cpu")
    args[3] = 0.1 * torch.randn(R, 256, generator=torch.Generator().manual_seed(R * 7919 + T))
    args = [a.to(cuda).contiguous() for a in args]
    assert k2.fused_tiling(R, 256, torch.float32).route == "cluster"
    before = _build.launch_counts()
    got = k2.gru_downsample_fused(*args)
    torch.cuda.synchronize()
    ran = _build.launches_since(before)["gru_downsample"]
    assert ran == {"cluster bfloat16": 0, "cluster float32": 1, "block": 0}
    assert got.shape == (R, (T + 1) // 2, 256)
    torch.testing.assert_close(got, k2.gru_downsample_reference(*args), atol=5e-5, rtol=0)


@pytest.mark.parametrize("R,T", [(9, 200), (128, 100)])
def test_gru_downsample_f32_cluster_repeats_bit_for_bit(cuda, state, R, T):
    """20 launches of the f32 cluster kernel give outputs equal bit for
    bit (its three h buffers, the conv after the send and the statistics'
    exchange hold no race that shows)."""
    args = [a.contiguous() for a in _gru_args(state, R, T, cuda)]
    first = k2.gru_downsample_fused(*args)
    for _ in range(19):
        assert torch.equal(k2.gru_downsample_fused(*args), first)


@pytest.mark.parametrize("R,T", [(1, 33), (3, 48), (9, 7)])
def test_gru_downsample_f32_cluster_reads_nothing_past_r_or_t(cuda, state, R, T):
    """x_proj and h0 as views between NaN rows: finite outputs equal to the
    plain version, so the f32 cluster kernel reads no row past R and no
    step past T."""
    args = _gru_args(state, R, T, cuda)

    def nan_framed(core):
        buf = torch.full((R + 2, *core.shape[1:]), float("nan"), dtype=core.dtype, device=cuda)
        buf[1:R + 1] = core
        view = buf[1:R + 1]
        assert view.is_contiguous() and view.data_ptr() % 16 == 0
        return view

    args[0], args[3] = nan_framed(args[0]), nan_framed(args[3])
    out = k2.gru_downsample_fused(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, k2.gru_downsample_reference(*args), atol=5e-5, rtol=0)


F32_K3_ROWS = [1, 2, 3, 9, 17, 32, 128, 512]
F32_K3_STEPS = [1, 2, 33, 1999]


@pytest.mark.parametrize("T", F32_K3_STEPS)
@pytest.mark.parametrize("R", F32_K3_ROWS)
def test_gru_recurrence_cluster_kernel_matches_plain_f32(cuda, state, R, T):
    """float32 at H = 256: K3's f32 cluster kernel (2 to 32 rows a cluster,
    partial tiles) against the plain version at the float32 bar, with a
    nonzero h0; one launch, on the cluster kernel by the launch ledger."""
    args = _gru_args(state, R, T, "cpu")[:4]
    args[3] = 0.1 * torch.randn(R, 256, generator=torch.Generator().manual_seed(R * 7919 + T))
    args = [a.to(cuda).contiguous() for a in args]
    assert k3.forward_tiling(R, 256, torch.float32).route == "cluster"
    before = _build.launch_counts()
    ys, h_last = k3.gru_recurrence(*args)
    torch.cuda.synchronize()
    ran = _build.launches_since(before)["gru_recurrence"]
    assert ran == {"cluster bfloat16": 0, "cluster float32": 1, "block": 0}
    want, _ = k3.gru_recurrence_reference(*args)
    torch.testing.assert_close(ys, want, atol=5e-6, rtol=0)
    assert torch.equal(h_last, ys[:, -1])


@pytest.mark.parametrize("R,T", [(9, 200), (128, 100)])
def test_gru_recurrence_f32_cluster_repeats_bit_for_bit(cuda, state, R, T):
    """20 launches of K3's f32 cluster kernel give outputs equal bit for bit
    (its two h buffers and the exchange hold no race that shows)."""
    args = [a.contiguous() for a in _gru_args(state, R, T, cuda)[:4]]
    first = k3.gru_recurrence(*args)[0]
    for _ in range(19):
        assert torch.equal(k3.gru_recurrence(*args)[0], first)


@pytest.mark.parametrize("R,T", [(1, 33), (3, 48), (17, 7)])
def test_gru_recurrence_f32_cluster_reads_nothing_past_r_or_t(cuda, state, R, T):
    """x_proj and h0 as views between NaN rows: finite outputs equal to the
    plain version, so K3's f32 cluster kernel reads no row past R and no
    step past T."""
    args = _gru_args(state, R, T, cuda)[:4]

    def nan_framed(core):
        buf = torch.full((R + 2, *core.shape[1:]), float("nan"), dtype=core.dtype, device=cuda)
        buf[1:R + 1] = core
        view = buf[1:R + 1]
        assert view.is_contiguous() and view.data_ptr() % 16 == 0
        return view

    args[0], args[3] = nan_framed(args[0]), nan_framed(args[3] + 0.1)
    ys, _ = k3.gru_recurrence(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ys).all())
    torch.testing.assert_close(ys, k3.gru_recurrence_reference(*args)[0], atol=5e-6, rtol=0)


@pytest.mark.parametrize("R,T", [(9, 200), (128, 100)])
def test_gru_cluster_kernels_repeat_bit_for_bit(cuda, state, R, T):
    """20 launches of each cluster kernel give outputs equal bit for bit: a
    missing release / acquire between the CTAs of a cluster would show as
    outputs that differ now and then."""
    args = _bf16_gru_args(state, R, T, cuda, torch.Generator().manual_seed(11))
    first_ys = k3.gru_recurrence(*args[:4])[0]
    first_out = k2.gru_downsample_fused(*args)
    for _ in range(19):
        assert torch.equal(k3.gru_recurrence(*args[:4])[0], first_ys)
        assert torch.equal(k2.gru_downsample_fused(*args), first_out)


@pytest.mark.parametrize("R,T", [(1, 33), (3, 48), (9, 7)])
def test_gru_cluster_kernels_read_nothing_past_r_or_t(cuda, state, R, T):
    """x_proj and h0 are views into buffers whose row before and row after
    hold NaN: finite outputs equal to the plain versions, so neither kernel
    reads a row past R (the tile's zero rows) or a step past T (the row
    after the last one starts right after its step T - 1)."""
    gen = torch.Generator().manual_seed(R + T)
    args = _bf16_gru_args(state, R, T, cuda, gen)

    def nan_framed(core):
        buf = torch.full((R + 2, *core.shape[1:]), float("nan"), dtype=core.dtype, device=cuda)
        buf[1:R + 1] = core
        view = buf[1:R + 1]
        assert view.is_contiguous() and view.data_ptr() % 16 == 0
        return view

    args[0], args[3] = nan_framed(args[0]), nan_framed(args[3])
    ys = k3.gru_recurrence(*args[:4])[0]
    out = k2.gru_downsample_fused(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ys).all()) and bool(torch.isfinite(out).all())
    want_ys, _ = k3.gru_recurrence_reference(*args[:4])
    want_out = k2.gru_downsample_reference(*args)
    torch.testing.assert_close(ys.float(), want_ys.float(), atol=bf16_tol(want_ys, 2), rtol=0)
    torch.testing.assert_close(out.float(), want_out.float(), atol=bf16_tol(want_out, 2), rtol=0)


def test_gru_routes_by_dtype_and_width(cuda, state):
    """H = 128 takes the block kernels (and they still match their plain
    versions), float32 K2 and K3 at H = 256 their f32 cluster kernels (the
    block kernels before they were ported); every cluster tiling the rule may
    pick reports the shared memory the rule reckons and fits at least one
    cluster."""
    for fused, tilings, info, lib in (
            (False, gcl.RECURRENCE_TILINGS, "vap_gru_recurrence_cluster_info", k3._lib()),
            (False, gcl.F32_RECURRENCE_TILINGS, "vap_gru_recurrence_cluster_f32_info", k3._lib()),
            (True, gcl.DOWNSAMPLE_TILINGS, "vap_gru_downsample_cluster_info", k2._lib()),
            (True, gcl.F32_DOWNSAMPLE_TILINGS, "vap_gru_downsample_cluster_f32_info", k2._lib())):
        resident = gcl.card_max_clusters(lib, info)  # raises if the bytes disagree
        for c, n in tilings:
            assert resident(c, n) >= 1
    assert k3.forward_tiling(32, 256, torch.float32).route == "cluster"
    assert k2.fused_tiling(128, 256, torch.float32).route == "cluster"
    gen = torch.Generator().manual_seed(3)
    xp = (0.5 * torch.randn(3, 40, 384, generator=gen)).to(cuda, torch.bfloat16)
    w = (torch.randn(128, 384, generator=gen) / 12).to(cuda, torch.bfloat16)
    b = (0.1 * torch.randn(384, generator=gen)).to(cuda, torch.bfloat16)
    h0 = (0.1 * torch.randn(3, 128, generator=gen)).to(cuda, torch.bfloat16)
    assert k3.forward_tiling(3, 128, torch.bfloat16).route == "block"
    ys, _ = k3.gru_recurrence(xp, w, b, h0)
    want, _ = k3.gru_recurrence_reference(xp, w, b, h0)
    torch.testing.assert_close(ys.float(), want.float(), atol=bf16_tol(want, 2), rtol=0)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("T", [1000, 3000, 77, 1])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_attention_kernels_match_plain(cuda, T, rate, dtype, dh):
    """The forward (out, lse) against its plain version: float32 (the
    3xTF32 tensor-core kernel) to 5e-6, bfloat16 out to two roundings (lse
    is f32 either way). The backward: float32 (the 3xTF32
    tensor-core kernels) against autograd through the masked dense
    forward; bfloat16 (the tensor-core kernels) against the plain backward
    on the same out and lse, to three roundings (Y, dS, output).
    At each head width the kernels take (256 / dh heads)."""
    q, k, v, do = (torch.randn(2, 256 // dh, T, dh, device=cuda).to(dtype) for _ in range(4))
    s = alibi_slopes(256 // dh).to(cuda)
    out, lse = ft.flash_train_forward(q, k, v, s, 99, 1 / 16, rate)
    torch.cuda.synchronize()
    want, want_lse = ft.train_forward_reference(q, k, v, s, 99, 1 / 16, rate)
    tol = 5e-6 if dtype == torch.float32 else bf16_tol(want)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=5e-6, rtol=0)
    got = ft.flash_train_backward(q, k, v, s, 99, out, lse, do, 1 / 16, rate)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        delta = (do.float() * out.float()).sum(-1).reshape(-1, T)
        for g, w in zip(got, ft.train_backward_reference(q, k, v, do, lse, delta, s, 99, 1 / 16, rate)):
            assert g.dtype == torch.bfloat16
            torch.testing.assert_close(g.float(), w.float(), atol=bf16_tol(w, 3), rtol=0)
        return
    # against autograd through the masked dense forward
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref, _ = ft.train_forward_reference(*leaves, s, 99, 1 / 16, rate)
    for g, w in zip(got, torch.autograd.grad(ref, leaves, do)):
        torch.testing.assert_close(g, w, atol=2e-5 * max(float(w.abs().max()), 1.0), rtol=0)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_read_nothing_past_t(cuda, dtype, dh):
    """B = H = 1, T = 77, at each head width: q, k, v and dO are leading
    slices of buffers whose tail rows hold NaN. Every attention kernel (K4,
    K10, the training forward and backward) gives finite results equal to
    its plain version, so none reads a row past T (the tensor-core kernels
    zero-fill through the copies' source size, and at Dh 32 the columns
    past Dh too)."""
    gen = torch.Generator().manual_seed(77)
    bufs = []
    for _ in range(4):
        buf = torch.full((1, 1, 128, dh), float("nan"), dtype=dtype)
        buf[:, :, :77] = torch.randn(1, 1, 77, dh, generator=gen).to(dtype)
        bufs.append(buf.to(cuda))
    q, k, v, do = (b[:, :, :77] for b in bufs)
    assert q.is_contiguous()
    s = alibi_slopes(1).to(cuda)
    # (got, want, float32 bar, bf16 roundings): the float32 bars are
    # chip_smoke's F32_TOL; lse is f32 in either mode
    pairs = [(k4.flash_alibi_attention(q, k, v, s, 1 / 8), k4.dense_reference(q, k, v, s, 1 / 8), 5e-6, 2),
             (k4.flash_alibi_attention_offset(q, k, v, s, 1 / 8, 0),
              k4.dense_offset_reference(q, k, v, s, 1 / 8, 0), 5e-6, 2)]
    out, lse = ft.flash_train_forward(q, k, v, s, 3, 1 / 8, 0.1)
    want, want_lse = ft.train_forward_reference(q, k, v, s, 3, 1 / 8, 0.1)
    pairs += [(out, want, 5e-6, 2), (lse, want_lse, 5e-6, None)]
    got = ft.flash_train_backward(q, k, v, s, 3, out, lse, do, 1 / 8, 0.1)
    delta = (do.float() * out.float()).sum(-1).reshape(1, 77)
    plain = ft.train_backward_reference(q, k, v, do, lse, delta, s, 3, 1 / 8, 0.1)
    pairs += [(g, w, 5e-5, 3) for g, w in zip(got, plain)]
    torch.cuda.synchronize()
    for g, w, f32_tol, steps in pairs:
        assert bool(torch.isfinite(g).all())
        atol = f32_tol if dtype == torch.float32 or steps is None else bf16_tol(w, steps)
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_refuse_misaligned_input(cuda, dtype):
    """Both dtypes' inference kernels and backward pairs read 16-byte
    pieces: a view one element into its buffer is refused by K4, K10 and
    the backward, not read from an unaligned address."""
    odd = torch.randn(1 + 8 * 64, device=cuda).to(dtype)[1:].view(1, 1, 8, 64)
    s1 = alibi_slopes(1).to(cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        k4.flash_alibi_attention(odd, odd, odd, s1, 0.1)
    with pytest.raises(ValueError, match="16-byte boundary"):
        k4.flash_alibi_attention_offset(odd, odd, odd, s1, 0.1, 0)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ft.flash_train_backward(odd, odd, odd, s1, 0, odd, torch.zeros(1, 8, device=cuda), odd, 0.1, 0.1)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ft.flash_train_forward(odd, odd, odd, s1, 0, 0.1, 0.1)


def test_inference_attention_backward_matches_dense(cuda):
    leaves = [torch.randn(2, 4, 300, 64, device=cuda, requires_grad=True) for _ in range(3)]
    s = alibi_slopes(4).to(cuda)
    cot = torch.randn(2, 4, 300, 64, device=cuda)
    got = torch.autograd.grad(k4.flash_alibi_attention(*leaves, s, 1 / 16), leaves, cot)
    want = torch.autograd.grad(k4.dense_reference(*leaves, s, 1 / 16), leaves, cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_kernels_without_backward_raise_on_grad(cuda, state):
    """K2 alone has no backward (nor has JAX's ``gru_downsample_fused``): it
    raises on a grad-requiring input. K1 and K3 are autograd functions."""
    layers = [tuple(t.requires_grad_() for t in l) for l in _layers(state, cuda)]
    assert k1.fused_conv_stack(layers, torch.randn(2, 3200, device=cuda)).grad_fn is not None
    args = _gru_args(state, 2, 8, cuda)
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        k2.gru_downsample_fused(*args)
    ys, h_last = k3.gru_recurrence(*args[:4])
    assert ys.grad_fn is not None and h_last.grad_fn is not None
    with torch.no_grad():  # no grad requested: the kernel runs
        k2.gru_downsample_fused(*args)


def test_conv_stack_backward_matches_autograd_of_plain(cuda, state):
    """K1's backward (autograd through ``reference_stack`` on the saved
    inputs, as JAX ``_vjp_bwd``) against autograd through the plain stack."""
    layers = [tuple(t.requires_grad_() for t in l) for l in _layers(state, cuda)]
    x = (0.1 * torch.randn(2, 16000, device=cuda)).requires_grad_()
    leaves = [x, *(t for l in layers for t in l)]
    cot = torch.randn(2, 100, 256, device=cuda)
    before = _build.launch_counts()
    got = torch.autograd.grad(k1.fused_conv_stack(layers, x), leaves, cot)
    assert _launched(before)["conv_stack"] == 5
    want = torch.autograd.grad(k1.reference_stack(layers, x), leaves, cot)
    for g, w in zip(got, want):
        # the backward is the same computation; only the forward's tile sums differ
        torch.testing.assert_close(g, w, atol=1e-4 * max(float(w.abs().max()), 1.0), rtol=0)


def _gru_bwd_args(state, R, T, device, dtype):
    gen = torch.Generator().manual_seed(R * 10000 + T)
    x_proj = 0.5 * torch.randn(R, T, 768, generator=gen)
    h0 = 0.1 * torch.randn(R, 256, generator=gen)
    dys = torch.randn(R, T, 256, generator=gen)
    args = [x_proj, state["encoder.gAR.w_hh"], state["encoder.gAR.b_hh"], h0]
    return [a.to(device, dtype).contiguous() for a in args], dys.to(device, dtype)


@pytest.mark.parametrize("R,T", [(32, 2000), (3, 1999), (32, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_backward_kernel_matches_plain(cuda, state, R, T, dtype):
    args, dys = _gru_bwd_args(state, R, T, cuda, dtype)
    ys, _ = k3.gru_recurrence(*args)
    before = _build.launch_counts()
    got = k3.gru_backward(*args, ys, dys)
    torch.cuda.synchronize()
    assert _launched(before)["gru_backward"] == 1
    want = k3.gru_backward_reference(*args, ys, dys)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        # float32: 1e-5 of the largest gradient (sums in another order)
        tol = 1e-5 * max(float(w.abs().max()), 1.0) if dtype == torch.float32 else bf16_tol(w)
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)


def test_gru_backward_kernel_matches_autograd_of_plain_forward(cuda, state):
    """float32: K3 + K9 through ``gru_recurrence`` against autograd through
    the plain forward loop, with a cotangent on ys and one on h_last."""
    args, dys = _gru_bwd_args(state, 3, 500, cuda, torch.float32)
    dh = torch.randn(3, 256, device=cuda)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, h_last = k3.gru_recurrence(*leaves)
    got = torch.autograd.grad((ys * dys).sum() + (h_last * dh).sum(), leaves)
    ys_p, h_p = k3.gru_recurrence_reference(*leaves)
    want = torch.autograd.grad((ys_p * dys).sum() + (h_p * dh).sum(), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5 * max(float(w.abs().max()), 1.0), rtol=0)


def _bf16_bwd_args(state, R, T, device, gen):
    """bf16 inputs of K9 (x_proj, w_hh, b_hh, a nonzero h0) with a dys and a
    dh_last, drawn on the CPU."""
    x_proj = 0.5 * torch.randn(R, T, 768, generator=gen)
    h0 = 0.1 * torch.randn(R, 256, generator=gen)
    args = [x_proj, state["encoder.gAR.w_hh"], state["encoder.gAR.b_hh"], h0]
    dys, dh_last = torch.randn(R, T, 256, generator=gen), torch.randn(R, 256, generator=gen)
    return ([a.to(device, torch.bfloat16).contiguous() for a in args], dys.to(device, torch.bfloat16),
            dh_last.to(device, torch.bfloat16))


@pytest.mark.parametrize("T", GRU_STEPS)
@pytest.mark.parametrize("R", GRU_ROWS)
def test_gru_backward_cluster_matches_plain_bf16(cuda, state, R, T):
    """bfloat16 at H = 256: K9's cluster design (partial tiles at R = 1, 3,
    9; T = 1 and odd T for the buffers' phases) against the plain version
    on the same ys (from K3), with a nonzero h0 and a dh_last, at the bar of
    ``chip_smoke.py`` (two bf16 roundings at each output's largest)."""
    args, dys, dh_last = _bf16_bwd_args(state, R, T, cuda, torch.Generator().manual_seed(R * 7919 + T))
    assert k3.backward_tiling(R, 256, torch.bfloat16).route == "cluster"
    ys, _ = k3.gru_recurrence(*args)
    before = _build.launch_counts()
    got = k3.gru_backward(*args, ys, dys, dh_last)
    torch.cuda.synchronize()
    assert _launched(before)["gru_backward"] == 1
    want = k3.gru_backward_reference(*args, ys, dys, dh_last)
    for name, g, w in zip(("dx_proj", "dw_hh", "db_hh", "dh0"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.bfloat16, name
        torch.testing.assert_close(g.float(), w.float(), atol=bf16_tol(w), rtol=0, msg=name)


@pytest.mark.parametrize("R,T", [(9, 200), (32, 2000)])
def test_gru_backward_cluster_repeats_bit_for_bit(cuda, state, R, T):
    """20 launches of K9's cluster design give outputs equal bit for bit:
    no atomics, the partial slices added in rank order whatever order they
    land in, the weight slices summed in slice order."""
    args, dys, dh_last = _bf16_bwd_args(state, R, T, cuda, torch.Generator().manual_seed(13))
    ys, _ = k3.gru_recurrence(*args)
    first = k3.gru_backward(*args, ys, dys, dh_last)
    for _ in range(19):
        for g, f in zip(k3.gru_backward(*args, ys, dys, dh_last), first):
            assert torch.equal(g, f)


@pytest.mark.parametrize("R,T", [(1, 33), (3, 48), (9, 7)])
def test_gru_backward_cluster_reads_nothing_past_r_or_t(cuda, state, R, T):
    """x_proj, ys, dys and h0 are views into buffers whose row before and
    row after hold NaN: finite outputs equal to the plain version, so no
    kernel of the design reads a row past R or a step past T."""
    args, dys, dh_last = _bf16_bwd_args(state, R, T, cuda, torch.Generator().manual_seed(R + T))
    ys, _ = k3.gru_recurrence(*args)

    def nan_framed(core):
        buf = torch.full((R + 2, *core.shape[1:]), float("nan"), dtype=core.dtype, device=cuda)
        buf[1:R + 1] = core
        view = buf[1:R + 1]
        assert view.is_contiguous() and view.data_ptr() % 16 == 0
        return view

    args[0], args[3] = nan_framed(args[0]), nan_framed(args[3])
    ys, dys = nan_framed(ys), nan_framed(dys)
    got = k3.gru_backward(*args, ys, dys, dh_last)
    torch.cuda.synchronize()
    want = k3.gru_backward_reference(*args, ys, dys, dh_last)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), atol=bf16_tol(w), rtol=0)


def test_gru_backward_routes_by_dtype_and_width(cuda, state):
    """float32 at H = 256 takes its cluster design, H = 128 the block kernel
    in either dtype (and still matches the plain version), by the wrapper's
    counts; every backward tiling of both dtypes reports the shared memory
    the rule reckons and fits at least one cluster; a tiling a kernel is
    not built for raises at launch and runs nothing else."""
    for dtype, tilings in ((torch.bfloat16, gcl.BACKWARD_TILINGS), (torch.float32, gcl.F32_BACKWARD_TILINGS)):
        resident = gcl.card_max_clusters(k3._backward_lib(), k3.BACKWARD_CLUSTER_ENTRIES[dtype][1])
        for c, n in tilings:
            assert resident(c, n) >= 1
    assert k3.backward_tiling(32, 256, torch.float32).route == "cluster"
    assert k3.backward_tiling(3, 128, torch.bfloat16).route == "block"
    assert k3.backward_tiling(3, 128, torch.float32).route == "block"
    gen = torch.Generator().manual_seed(5)
    for dtype in (torch.bfloat16, torch.float32):
        xp = (0.5 * torch.randn(3, 40, 384, generator=gen)).to(cuda, dtype)
        w = (torch.randn(128, 384, generator=gen) / 12).to(cuda, dtype)
        b = (0.1 * torch.randn(384, generator=gen)).to(cuda, dtype)
        h0 = (0.1 * torch.randn(3, 128, generator=gen)).to(cuda, dtype)
        ys, _ = k3.gru_recurrence(xp, w, b, h0)
        dys = torch.randn(3, 40, 128, generator=gen).to(cuda, dtype)
        before = _build.launch_counts()
        got = k3.gru_backward(xp, w, b, h0, ys, dys)
        assert _build.launches_since(before)["gru_backward"] == {
            "cluster bfloat16": 0, "cluster float32": 0, "block": 1}
        for g, want in zip(got, k3.gru_backward_reference(xp, w, b, h0, ys, dys)):
            tol = bf16_tol(want) if dtype == torch.bfloat16 else 1e-5 * max(float(want.abs().max()), 1.0)
            torch.testing.assert_close(g.float(), want.float(), atol=tol, rtol=0)
    args, dys, _ = _bf16_bwd_args(state, 8, 16, cuda, gen)
    ys, _ = k3.gru_recurrence(*args)
    launch, _ = k3.cluster_backward_launcher(*args, ys, dys, gcl.Tiling("cluster", cluster=4, rows=8, tiles=2))
    with pytest.raises(RuntimeError, match="gru_backward: CUDA error"):
        launch(sum(k3.BACKWARD_PHASES.values()))
    args, dys = _gru_bwd_args(state, 8, 16, cuda, torch.float32)
    ys, _ = k3.gru_recurrence(*args)
    launch, _ = k3.cluster_backward_launcher(*args, ys, dys, gcl.Tiling("cluster", cluster=8, rows=3, tiles=3))
    with pytest.raises(RuntimeError, match="gru_backward: CUDA error"):
        launch(sum(k3.BACKWARD_PHASES.values()))


def _f32_bwd_args(state, R, T, device, gen):
    """float32 inputs of K9 (x_proj, w_hh, b_hh, a nonzero h0) with a dys
    and a dh_last, drawn on the CPU."""
    x_proj = 0.5 * torch.randn(R, T, 768, generator=gen)
    h0 = 0.1 * torch.randn(R, 256, generator=gen)
    args = [x_proj, state["encoder.gAR.w_hh"], state["encoder.gAR.b_hh"], h0]
    dys, dh_last = torch.randn(R, T, 256, generator=gen), torch.randn(R, 256, generator=gen)
    return [a.to(device, torch.float32).contiguous() for a in args], dys.to(device), dh_last.to(device)


@pytest.mark.parametrize("T", GRU_STEPS)
@pytest.mark.parametrize("R", GRU_ROWS)
def test_gru_backward_f32_cluster_matches_plain(cuda, state, R, T):
    """float32 at H = 256: K9's f32 cluster design (partial tiles at R = 1,
    3, 9; T = 1 and odd T for the buffers' phases) against the plain
    version on the same ys (from K3), with a nonzero h0 and a dh_last, at
    1e-5 of each output's largest magnitude; one launch, on the design."""
    args, dys, dh_last = _f32_bwd_args(state, R, T, cuda, torch.Generator().manual_seed(R * 7907 + T))
    assert k3.backward_tiling(R, 256, torch.float32).route == "cluster"
    ys, _ = k3.gru_recurrence(*args)
    before = _build.launch_counts()
    got = k3.gru_backward(*args, ys, dys, dh_last)
    torch.cuda.synchronize()
    assert _build.launches_since(before)["gru_backward"] == {
        "cluster bfloat16": 0, "cluster float32": 1, "block": 0}
    want = k3.gru_backward_reference(*args, ys, dys, dh_last)
    for name, g, w in zip(("dx_proj", "dw_hh", "db_hh", "dh0"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32, name
        torch.testing.assert_close(g, w, atol=1e-5 * max(float(w.abs().max()), 1.0), rtol=0, msg=name)


@pytest.mark.parametrize("R,T", [(9, 200), (32, 2000)])
def test_gru_backward_f32_cluster_repeats_bit_for_bit(cuda, state, R, T):
    """20 launches of K9's f32 cluster design give outputs equal bit for
    bit: the slices added in rank order, the weight slices in slice order."""
    args, dys, dh_last = _f32_bwd_args(state, R, T, cuda, torch.Generator().manual_seed(11))
    ys, _ = k3.gru_recurrence(*args)
    first = k3.gru_backward(*args, ys, dys, dh_last)
    for _ in range(19):
        for g, f in zip(k3.gru_backward(*args, ys, dys, dh_last), first):
            assert torch.equal(g, f)


@pytest.mark.parametrize("R,T", [(1, 33), (3, 48), (9, 7)])
def test_gru_backward_f32_cluster_reads_nothing_past_r_or_t(cuda, state, R, T):
    """x_proj, ys, dys and h0 are views into buffers whose row before and
    row after hold NaN: finite outputs equal to the plain version, so no
    launch of the f32 design reads a row past R or a step past T."""
    args, dys, dh_last = _f32_bwd_args(state, R, T, cuda, torch.Generator().manual_seed(R + T + 1))
    ys, _ = k3.gru_recurrence(*args)

    def nan_framed(core):
        buf = torch.full((R + 2, *core.shape[1:]), float("nan"), dtype=core.dtype, device=cuda)
        buf[1:R + 1] = core
        view = buf[1:R + 1]
        assert view.is_contiguous() and view.data_ptr() % 16 == 0
        return view

    args[0], args[3] = nan_framed(args[0]), nan_framed(args[3])
    ys, dys = nan_framed(ys), nan_framed(dys)
    got = k3.gru_backward(*args, ys, dys, dh_last)
    torch.cuda.synchronize()
    want = k3.gru_backward_reference(*args, ys, dys, dh_last)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, atol=1e-5 * max(float(w.abs().max()), 1.0), rtol=0)


def test_gru_backward_cluster_matches_autograd_of_plain_forward_bf16(cuda, state):
    """bfloat16: K3 + K9 (the cluster designs) through ``gru_recurrence``
    against autograd through the plain forward loop on the same bf16
    leaves, with a cotangent on ys and one on h_last, at the bf16 bar."""
    args, dys, dh = _bf16_bwd_args(state, 3, 500, cuda, torch.Generator().manual_seed(17))
    leaves = [a.clone().requires_grad_() for a in args]
    before = _build.launch_counts()
    ys, h_last = k3.gru_recurrence(*leaves)
    got = torch.autograd.grad((ys.float() * dys.float()).sum() + (h_last.float() * dh.float()).sum(), leaves)
    assert _launched(before)["gru_backward"] == 1
    ys_p, h_p = k3.gru_recurrence_reference(*leaves)
    want = torch.autograd.grad((ys_p.float() * dys.float()).sum() + (h_p.float() * dh.float()).sum(), leaves)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), atol=bf16_tol(w), rtol=0)


def _train_step_on_both(state, dropout):
    conf = VapConfig(dropout=dropout)
    rng = np.random.default_rng(2)
    batch = {"waveform": (0.1 * rng.standard_normal((1, 2, 16000))).astype(np.float32),
             "vad": (rng.random((1, 150, 2)) < 0.5).astype(np.float32)}
    nets = {}
    for device in ("cpu", "cuda"):
        net = VapNet(conf)
        net.load_state_dict(state)
        net.to(device)
        before = _build.launch_counts()
        step = tstep.make_train_step(conf, tstep.make_optimizer(OptConfig(), net))
        metrics = step(net, batch, torch.Generator().manual_seed(0))
        nets[device] = (net, {k: float(v) for k, v in metrics.items()})
    # the card step's attention ran the training kernels, with or without dropout
    launched = _launched(before)
    assert (launched["flash_train_forward"], launched["flash_train_backward"]) == (14, 14)
    return nets


def test_train_step_on_card_matches_cpu(cuda, state):
    """One frozen-encoder step at dropout 0, float32, B=1 x 1 s."""
    nets = _train_step_on_both(state, 0.0)
    (cpu, m_cpu), (card, m_card) = nets["cpu"], nets["cuda"]
    for key in m_cpu:
        assert abs(m_cpu[key] - m_card[key]) < 1e-4, key
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        if p.grad is None:
            assert q.grad is None, name
            continue
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-4 * max(float(p.grad.abs().max()), 1e-6),
                                   rtol=0, msg=name)


def test_dropout_train_step_on_card_matches_cpu(cuda, state, monkeypatch):
    """One frozen-encoder step at dropout 0.1, float32, B=1 x 1 s. The
    attention masks are the kernels' coordinate hash on either device; the
    elementwise masks are drawn on the CPU from the seed of the step's masks
    generator on both sides (on the CPU these are the port's own masks)."""
    from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng

    def dropout(self, x, rate, tp=None):  # unsharded nets: no model shard
        if not hasattr(self, "cpu_masks"):
            self.cpu_masks = torch.Generator().manual_seed(self.masks.initial_seed())
        keep = (torch.rand(x.shape, generator=self.cpu_masks) >= rate).to(x.device)
        return torch.where(keep, x / (1.0 - rate), 0.0)

    monkeypatch.setattr(DropoutRng, "dropout", dropout)
    nets = _train_step_on_both(state, 0.1)
    (cpu, m_cpu), (card, m_card) = nets["cpu"], nets["cuda"]
    for key in m_cpu:
        assert abs(m_cpu[key] - m_card[key]) < 1e-4, key
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        if p.grad is None:
            assert q.grad is None, name
            continue
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-4 * max(float(p.grad.abs().max()), 1e-6),
                                   rtol=0, msg=name)


def test_unfrozen_train_step_on_card_matches_cpu(cuda, state):
    """One unfrozen step at dropout 0, float32, B=1 x 1 s: the plain conv
    stack, K3 forward and K9 backward, the training attention kernels."""
    conf = VapConfig(dropout=0.0, freeze_encoder=False)
    rng = np.random.default_rng(3)
    batch = {"waveform": (0.1 * rng.standard_normal((1, 2, 16000))).astype(np.float32),
             "vad": (rng.random((1, 150, 2)) < 0.5).astype(np.float32)}
    nets = {}
    for device in ("cpu", "cuda"):
        net = VapNet(conf)
        net.load_state_dict(state)
        net.to(device)
        before = _build.launch_counts()
        step = tstep.make_train_step(conf, tstep.make_optimizer(OptConfig(), net, freeze_encoder=False))
        metrics = step(net, batch, torch.Generator().manual_seed(0))
        nets[device] = (net, {k: float(v) for k, v in metrics.items()})
    launched = _launched(before)
    assert [launched[op] for op in ("conv_stack", "gru_recurrence", "gru_backward", "flash_train_forward")] == [
        0, 1, 1, 14]
    (cpu, m_cpu), (card, m_card) = nets["cpu"], nets["cuda"]
    for key in m_cpu:
        assert abs(m_cpu[key] - m_card[key]) < 1e-5, key
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        assert p.grad is not None and q.grad is not None, name
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-4 * max(float(p.grad.abs().max()), 1e-6),
                                   rtol=0, msg=name)


def test_cpc_step_on_card_matches_cpu(cuda, state):
    """One CPC step, float32, B=2 x 0.32 s, the same negatives (drawn from
    the step's CPU generator on both devices): metrics and gradients."""
    from voiceactivityprojection_tpu_torch.models.checkpoint import encoder_from_jax
    from voiceactivityprojection_tpu_torch.train import cpc_pretrain as cpc

    tree = random_params_tree(VapConfig(), seed=0)["encoder"]
    wave = (0.1 * np.random.default_rng(4).standard_normal((2, 5120))).astype(np.float32)
    res = {}
    for device in ("cpu", "cuda"):
        heads = cpc.init_cpc_heads(torch.Generator().manual_seed(0), 12, 256, 256)
        st = cpc.init_cpc_train_state(encoder_from_jax(tree), heads, device=device)
        before = _build.launch_counts()
        m = cpc.make_cpc_train_step(12, 128)(st, wave, torch.Generator().manual_seed(1))
        res[device] = (st, {k: float(v) for k, v in m.items()})
    assert _launched(before)["gru_backward"] == 1
    assert _build.launches_since(before)["cpc_infonce"] == {"forward float32": 1, "backward float32": 1}
    (cpu, m_cpu), (card, m_card) = res["cpu"], res["cuda"]
    assert abs(m_cpu["cpc_loss"] - m_card["cpc_loss"]) < 1e-5
    pairs = [*zip(cpu.encoder.named_parameters(), card.encoder.parameters()),
             (("heads.W", cpu.heads.W), card.heads.W)]
    for (name, p), q in pairs:
        if p.grad is None:
            assert q.grad is None and name.startswith("downsample."), name
            continue
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-4 * max(float(p.grad.abs().max()), 1e-6),
                                   rtol=0, msg=name)


def _infonce_inputs(B, T, K, N, device, seed=0, ties=False):
    """z (B, T, 256), preds (K, B, T - K, 256) at scores of a few units, idx
    (B, T - K, N) uniform over the B * T rows; with ``ties`` every third
    row's first negative is its head-1 positive and its last two negatives
    are one row."""
    g = torch.Generator().manual_seed(seed)
    Tc = T - K
    z = torch.randn(B, T, 256, generator=g)
    preds = torch.randn(K, B, Tc, 256, generator=g) / 16
    idx = torch.randint(0, B * T, (B, Tc, N), generator=g)
    if ties:
        idx[:, ::3, 0] = (torch.arange(B)[:, None] * T + torch.arange(0, Tc, 3)[None] + 1)
        if N > 2:
            idx[..., -1] = idx[..., -2]
    return z.to(device), preds.to(device), idx.to(device)


def _infonce_plain_f64(z, preds, idx):
    """The plain version in float64 on the card: loss, dz, dpreds (autograd),
    and per head the hits counted with each negative that is the row's
    positive left out (a tie, which K14 counts as a hit) and the rows whose
    margin is under 1e-4 (float32 rounding may turn those either way)."""
    from voiceactivityprojection_tpu_torch.ops import cpc_infonce as k14

    z64, p64 = z.double().requires_grad_(), preds.double().requires_grad_()
    loss, _ = k14.infonce_reference(z64, p64, idx)
    dz, dp = torch.autograd.grad(loss, [z64, p64])
    B, T, C = z.shape
    K, _, Tc, _ = preds.shape
    with torch.no_grad():
        zf = z64.reshape(B * T, C)
        negs = zf[idx]
        hits, near = [], []
        for k in range(K):
            rows = torch.arange(B, device=z.device)[:, None] * T + torch.arange(Tc, device=z.device)[None] + k + 1
            pos = (p64[k] * zf[rows]).sum(-1)
            neg = torch.einsum("btc,btnc->btn", p64[k], negs).masked_fill(idx == rows[..., None], -math.inf)
            margin = pos - neg.amax(-1)
            hits.append(int((margin >= 0).sum()))
            near.append(int((margin.abs() < 1e-4).sum()))
    return float(loss), dz, dp, hits, near


@pytest.mark.parametrize("B, T, K, N, ties", [
    (32, 128, 12, 128, False),  # the CPC cell's shape
    (32, 128, 12, 128, True),   # positives among their negatives, repeated indices
    (1, 13, 12, 5, False),      # B = 1, Tc = 1
    (4, 40, 12, 1, False),
    (4, 40, 12, 7, True),
    (4, 40, 12, 129, False),
    (4, 40, 1, 16, False),      # K = 1
    (3, 30, 5, 33, True),       # K = 5: three padded heads
    (2, 40, 16, 20, False),     # K = 16
], ids=["cell", "cell-ties", "b1-tc1", "n1", "n7-ties", "n129", "k1", "k5-ties", "k16"])
def test_infonce_kernels_match_float64(cuda, B, T, K, N, ties):
    """K14 forward and backward against the plain version in float64: the
    loss within 1e-6 relative, dz and dpreds within 2e-6 of each output's
    largest, each head's hits those of the plain version (ties counted as
    hits) up to its rows within 1e-4 of a tie; one launch each way."""
    from voiceactivityprojection_tpu_torch.ops import cpc_infonce as k14

    z, preds, idx = _infonce_inputs(B, T, K, N, cuda, seed=B + T + K + N, ties=ties)
    z.requires_grad_()
    preds.requires_grad_()
    before = _build.launch_counts()
    loss, aux = k14.infonce(z, preds, idx)
    assert _build.launches_since(before)["cpc_infonce"] == {"forward float32": 1, "backward float32": 0}
    dz, dp = torch.autograd.grad(loss, [z, preds])
    torch.cuda.synchronize()
    assert _build.launches_since(before)["cpc_infonce"] == {"forward float32": 1, "backward float32": 1}
    want, want_dz, want_dp, hits, near = _infonce_plain_f64(z.detach(), preds.detach(), idx)
    assert abs(float(loss) - want) <= 1e-6 * abs(want), (float(loss), want)
    for got, ref, name in ((dz, want_dz, "dz"), (dp, want_dp, "dpreds")):
        err = float((got.double() - ref).abs().max()) / float(ref.abs().max())
        assert err <= 2e-6, (name, err)
    Tc = T - K
    accs = [aux["cpc_acc_k1"], aux["cpc_acc_k12"]]
    for acc, k in zip(accs, (0, K - 1)):
        got_hits = round(float(acc) * B * Tc)
        assert abs(got_hits - hits[k]) <= near[k], (k, got_hits, hits[k], near[k])
    assert abs(float(aux["cpc_acc"]) - sum(hits) / (K * B * Tc)) <= (sum(near) + 0.5) / (K * B * Tc)


def test_infonce_loss_and_dpreds_repeat_bit_for_bit(cuda):
    """The loss (a fixed-order sum) and dpreds (written whole by one CTA) are
    the same from run to run; dz (atomic adds) within float32 rounding."""
    from voiceactivityprojection_tpu_torch.ops import cpc_infonce as k14

    z, preds, idx = _infonce_inputs(32, 128, 12, 128, cuda, seed=5)
    z.requires_grad_()
    preds.requires_grad_()
    runs = []
    for _ in range(3):
        loss, aux = k14.infonce(z, preds, idx)
        runs.append((loss.detach(), aux["cpc_acc"], *torch.autograd.grad(loss, [z, preds])))
    for loss, acc, dz, dp in runs[1:]:
        assert torch.equal(loss, runs[0][0]) and torch.equal(acc, runs[0][1]) and torch.equal(dp, runs[0][3])
        torch.testing.assert_close(dz, runs[0][2], atol=1e-6 * float(dz.abs().max()), rtol=0)


def test_infonce_index_out_of_range_makes_the_loss_nan(cuda):
    """An index outside [0, B * T) is not read: the loss is NaN (and its
    row's gradients), with no host sync and no fault; the launch counts."""
    from voiceactivityprojection_tpu_torch.ops import cpc_infonce as k14

    for bad in (4 * 40, -1, 2 ** 40):
        z, preds, idx = _infonce_inputs(4, 40, 12, 16, cuda, seed=7)
        idx[2, 5, 3] = bad
        z.requires_grad_()
        preds.requires_grad_()
        loss, aux = k14.infonce(z, preds, idx)
        dz, dp = torch.autograd.grad(loss, [z, preds])
        torch.cuda.synchronize()
        assert math.isnan(float(loss)), bad
        assert bool(dp[:, 2, 5].isnan().all()) and bool(torch.isfinite(dp[:, 2, 4]).all())
        assert bool(torch.isfinite(dz).all())  # no dz is written for the bad index
    z, preds, idx = _infonce_inputs(4, 40, 12, 16, cuda, seed=7)
    assert math.isfinite(float(k14.infonce(z, preds, idx)[0]))


def test_infonce_routes_on_the_card(cuda):
    """On the card bfloat16, a width other than 256 and more than 16 heads
    take the plain version (no launch); float32 at 256 the kernels."""
    from voiceactivityprojection_tpu_torch.ops import cpc_infonce as k14

    z, preds, idx = _infonce_inputs(2, 30, 12, 9, cuda)
    for zz, pp in ((z.bfloat16(), preds.bfloat16()), (z[..., :128], preds[..., :128])):
        before = _build.launch_counts()
        loss, _ = k14.infonce(zz, pp, idx)
        assert _launched(before)["cpc_infonce"] == 0
        assert torch.equal(loss, k14.infonce_reference(zz, pp, idx)[0])
    z17, p17, i17 = _infonce_inputs(2, 30, 17, 9, cuda)
    before = _build.launch_counts()
    k14.infonce(z17, p17, i17)
    assert _launched(before)["cpc_infonce"] == 0
    before = _build.launch_counts()
    k14.infonce(z, preds, idx)
    assert _launched(before)["cpc_infonce"] == 1


@pytest.mark.parametrize("Tq,Tk,off", [(1500, 6000, 0), (1500, 6000, 1500), (1500, 6000, 4500),
                                       (1000, 3337, 2337), (100, 300, 37), (1, 1, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_offset_attention_kernel_matches_plain(cuda, Tq, Tk, off, dtype, dh):
    """K10 at the context-parallel shapes (and ragged ones) against its plain
    version: float32 to the K4 bar, bfloat16 to two roundings (p and out);
    at each head width the kernels take (256 / dh heads)."""
    gen = torch.Generator().manual_seed(Tq + Tk + off)
    q = torch.randn(1, 256 // dh, Tq, dh, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(1, 256 // dh, Tk, dh, generator=gen).to(cuda, dtype) for _ in range(2))
    s = alibi_slopes(256 // dh).to(cuda)
    before = _build.launch_counts()
    got = k4.flash_alibi_attention_offset(q, k, v, s, 1 / 16, off)
    torch.cuda.synchronize()
    assert _launched(before)["flash_alibi_offset"] == 1
    want = k4.dense_offset_reference(q, k, v, s, 1 / 16, off)
    tol = 5e-6 if dtype == torch.float32 else bf16_tol(want)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def test_offset_attention_refuses_bad_offsets_and_grad(cuda):
    q = torch.randn(1, 4, 100, 64, device=cuda)
    k = torch.randn(1, 4, 300, 64, device=cuda)
    s = alibi_slopes(4).to(cuda)
    for off in (-1, 201):
        with pytest.raises(ValueError, match="must lie in"):
            k4.flash_alibi_attention_offset(q, k, k, s, 1 / 16, off)
    with pytest.raises(RuntimeError, match="no backward"):
        k4.flash_alibi_attention_offset(q.requires_grad_(), k, k, s, 1 / 16, 0)


# n whose n1 is one past a tile edge of the bfloat16 kernel: n1 = 257 = 2 * 128 + 1
CONV01_EDGE_N = 5139


@pytest.mark.parametrize("R,n", [(8, 320000), (4, 12345), (4, 16000), (3, 161), (1, 161), (1, 16000),
                                 (2, CONV01_EDGE_N), (128, 16000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv01_kernel_matches_plain(cuda, state, R, n, dtype):
    """K11 against the plain stack's first two layers: float32 (the 3xTF32
    kernel) to the conv stack's bar; bfloat16 (the wgmma kernel) to four
    roundings (each layer's output and, in the plain version, each conv
    sum, a step moving the next statistics)."""
    assert k11.route(dtype) == ("wgmma bfloat16" if dtype == torch.bfloat16 else "wgmma 3xtf32")
    layers = _layers(state, cuda, dtype)
    x = (0.1 * torch.randn(R, n, generator=torch.Generator().manual_seed(n))).to(cuda, dtype)
    before = _build.launch_counts()
    got = k11.fused_conv01(layers, x)
    torch.cuda.synchronize()
    assert _launched(before)["conv01"] == 1
    want = k11.reference_unfused(layers, x)
    assert got.shape == want.shape == (R, k11.out_len(n), 256)
    tol = 1e-4 if dtype == torch.float32 else bf16_tol(want, 4)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def _conv01_bf16(state, cuda, R, n, seed):
    layers = _layers(state, cuda, torch.bfloat16)[:2]
    x = (0.1 * torch.randn(R, n, generator=torch.Generator().manual_seed(seed))).to(cuda, torch.bfloat16)
    return layers, x


def test_conv01_bf16_repeats_bit_for_bit(cuda, state):
    """20 launches of the wgmma kernel (its W1 stages refilled by whichever
    warpgroup releases them last) give outputs equal bit for bit."""
    layers, x = _conv01_bf16(state, cuda, 3, 40000, 7)
    first = k11.fused_conv01(layers, x)
    for _ in range(19):
        assert torch.equal(k11.fused_conv01(layers, x), first)


@pytest.mark.parametrize("R", [1, 3])
def test_conv01_bf16_reads_nothing_outside_x(cuda, state, R):
    """x is a view into a buffer of NaN: for R = 1 the 4096 samples before
    and after the row, for R = 3 the rows before and after. Finite outputs
    equal to the plain version, so the kernel reads no sample before 0 or
    past n - 1 and no row past R - 1 (its padded taps meet zeros)."""
    layers, core = _conv01_bf16(state, cuda, R, 12345, R)
    n = core.shape[1]
    if R == 1:
        buf = torch.full((1, n + 8192), float("nan"), dtype=torch.bfloat16, device=cuda)
        buf[:, 4096:4096 + n] = core
        x = buf[:, 4096:4096 + n]
    else:
        buf = torch.full((R + 2, n), float("nan"), dtype=torch.bfloat16, device=cuda)
        buf[1:R + 1] = core
        x = buf[1:R + 1]
    assert x.is_contiguous()
    got = k11.fused_conv01(layers, x)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    want = k11.reference_unfused(layers, core)
    torch.testing.assert_close(got.float(), want.float(), atol=bf16_tol(want, 4), rtol=0)


def test_conv01_routes_by_dtype(cuda, state):
    """bfloat16 launches the wgmma kernel and float32 the 3xTF32 kernel
    after one W1 split (the library's own launch counts by kernel and the
    wrapper's); the library reports the shared memory and tile the wrapper
    reckons for each; refused launches raise (a misaligned w1, too many
    rows) and the library refuses a wrong n1."""
    for dtype in (torch.bfloat16, torch.float32):
        layers = _layers(state, cuda, dtype)[:2]
        x = (0.1 * torch.randn(2, 16000, device=cuda)).to(dtype)
        before, counted = k11.kernel_launches(), _build.launch_counts()
        k11.fused_conv01(layers, x)
        torch.cuda.synchronize()
        after = k11.kernel_launches()
        kernel = k11.route(dtype)
        assert {k: after[k] - before[k] for k in after} == {"wgmma bfloat16": int(kernel == "wgmma bfloat16"),
                                                           "wgmma 3xtf32": int(kernel == "wgmma 3xtf32")}
        assert _build.launches_since(counted)["conv01"] == {
            "wgmma bfloat16": int(dtype == torch.bfloat16), "wgmma 3xtf32": int(dtype == torch.float32),
            "split tf32": int(dtype == torch.float32)}
    assert k11.kernel_info(torch.bfloat16) == {"smem": k11.smem_bytes(), "tile": k11.TILE}
    assert k11.kernel_info(torch.float32) == {"smem": k11.f32_smem_bytes(), "tile": k11.TILE}
    layers, x = _conv01_bf16(state, cuda, 2, 16000, 1)
    flat = torch.empty(k11.K1 * 256 * 256 + 1, dtype=torch.bfloat16, device=cuda)
    w1 = flat[1:].view(k11.K1, 256, 256)
    w1.copy_(layers[1][0])
    with pytest.raises(ValueError, match="16-byte boundary"):
        k11.fused_conv01([layers[0], (w1, *layers[1][1:])], x)
    with pytest.raises(ValueError, match="unsupported input"):
        k11.fused_conv01(layers, torch.zeros(65536, 161, dtype=torch.bfloat16, device=cuda))
    out = torch.empty(2, 801, 256, dtype=torch.bfloat16, device=cuda)  # n1 is 800
    rc = k11._lib().vap_conv01(x.data_ptr(), *(t.data_ptr() for l in layers for t in l), out.data_ptr(),
                               2, 16000, 801, _build.dtype_code(torch.bfloat16), _build.stream_handle(x))
    assert rc != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check_launch(rc, "conv01", "wgmma bfloat16")


def _conv01_f32(state, cuda, R, n, seed):
    layers = _layers(state, cuda)[:2]
    x = (0.1 * torch.randn(R, n, generator=torch.Generator().manual_seed(seed))).to(cuda)
    return layers, x


def test_conv01_f32_repeats_bit_for_bit(cuda, state):
    """20 launches of the 3xTF32 kernel (and its W1 split) give outputs
    equal bit for bit."""
    layers, x = _conv01_f32(state, cuda, 3, 40000, 9)
    first = k11.fused_conv01(layers, x)
    for _ in range(19):
        assert torch.equal(k11.fused_conv01(layers, x), first)


@pytest.mark.parametrize("R", [1, 3])
def test_conv01_f32_reads_nothing_outside_x(cuda, state, R):
    """float32: x is a view into a buffer of NaN (for R = 1 the 4096 samples
    before and after the row, for R = 3 the rows before and after): finite
    outputs equal to the plain version, so the 3xTF32 kernel reads no sample
    before 0 or past n - 1 and no row past R - 1."""
    layers, core = _conv01_f32(state, cuda, R, 12345, R + 7)
    n = core.shape[1]
    if R == 1:
        buf = torch.full((1, n + 8192), float("nan"), device=cuda)
        buf[:, 4096:4096 + n] = core
        x = buf[:, 4096:4096 + n]
    else:
        buf = torch.full((R + 2, n), float("nan"), device=cuda)
        buf[1:R + 1] = core
        x = buf[1:R + 1]
    assert x.is_contiguous()
    got = k11.fused_conv01(layers, x)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, k11.reference_unfused(layers, core), atol=1e-4, rtol=0)


def test_conv01_backward_matches_autograd_of_plain(cuda, state):
    """K11's backward (autograd through ``reference_unfused`` on the saved
    inputs, as JAX ``_vjp_bwd``) against autograd through the plain layers."""
    layers = [tuple(t.requires_grad_() for t in l) for l in _layers(state, cuda)[:2]]
    x = (0.1 * torch.randn(2, 16000, device=cuda)).requires_grad_()
    leaves = [x, *(t for l in layers for t in l)]
    cot = torch.randn(2, 800, 256, device=cuda)
    got = torch.autograd.grad(k11.fused_conv01(layers, x), leaves, cot)
    want = torch.autograd.grad(k11.reference_unfused(layers, x), leaves, cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4 * max(float(w.abs().max()), 1.0), rtol=0)


# the ops a context-parallel or fused-conv call may launch, by kernel number
_CP_OPS = {"k1": "conv_stack", "k2": "gru_downsample", "k3": "gru_recurrence", "k4": "flash_alibi",
           "k10": "flash_alibi_offset", "k11": "conv01"}


@pytest.mark.parametrize("impl", [None, "fused"])
def test_context_parallel_on_card_matches_single_device(cuda, state, impl, monkeypatch):
    """60 s of stereo over a 4-shard mesh on one card, float32: K10 at every
    attention site of every shard, K3 once per shard (and K11 once per
    shard under ``VAP_CONV_IMPL=fused``); logits and vad within 2e-4 of the
    single-device forward on the card."""
    from voiceactivityprojection_tpu_torch.models.vap import forward
    from voiceactivityprojection_tpu_torch.parallel.context import forward_context_parallel
    from voiceactivityprojection_tpu_torch.parallel.mesh import make_mesh

    conf = VapConfig()
    net = VapNet(conf)
    net.load_state_dict(state)
    net.to(cuda).requires_grad_(False)
    wave = torch.from_numpy((0.1 * np.random.default_rng(5).standard_normal((1, 2, 60 * 16000)))
                            .astype(np.float32)).to(cuda)
    want = forward(net, wave, conf)
    if impl is not None:
        monkeypatch.setenv("VAP_CONV_IMPL", impl)
    before = _build.launch_counts()
    got = forward_context_parallel(net, wave, conf, make_mesh(n_data=4, devices=[cuda] * 4))
    torch.cuda.synchronize()
    launched = _launched(before)
    launches = {k: launched[op] for k, op in _CP_OPS.items()}
    assert launches == {"k1": 0, "k2": 0, "k3": 4, "k4": 0, "k10": 56, "k11": 4 if impl else 0}
    for key in ("logits", "vad"):
        assert got[key].shape == want[key].shape
        torch.testing.assert_close(got[key], want[key], atol=2e-4, rtol=0)


def test_conv_impl_fused_runs_k11_in_inference(cuda, state, monkeypatch):
    """``VAP_CONV_IMPL=fused``: stereo inference runs K11 once per request
    and not K1; p_now / p_future within the float32 bar of the default."""
    monkeypatch.setenv("VAP_CONV_IMPL", "fused")
    wave = (0.1 * np.random.default_rng(6).standard_normal((2, 2, 32000))).astype(np.float32)
    model = VapModel(VapConfig(), state, device="cuda")
    before = _build.launch_counts()
    got = model.probs(wave)
    launched = _launched(before)
    assert (launched["conv01"], launched["conv_stack"]) == (1, 0)
    monkeypatch.delenv("VAP_CONV_IMPL")
    want = model.probs(wave)
    for key in ("p_now", "p_future"):
        torch.testing.assert_close(got[key], want[key], atol=2e-4, rtol=0)


def test_mono_model_on_card_matches_cpu(cuda):
    """The mono model with history conditioning, float32, B=2 x 1 s."""
    from voiceactivityprojection_tpu_torch.config import VapMonoConfig
    from voiceactivityprojection_tpu_torch.models.vap import VapMonoModel

    conf = VapMonoConfig(va_history=True)
    mstate = params_from_jax(random_params_tree(conf, seed=1), conf)
    rng = np.random.default_rng(7)
    wave = (0.1 * rng.standard_normal((2, 1, 16000))).astype(np.float32)
    va = (rng.random((2, 60, 2)) < 0.4).astype(np.float32)
    vah = rng.random((2, 60, 5)).astype(np.float32)
    got = VapMonoModel(conf, mstate, device="cuda").probs(wave, va, vah)
    want = VapMonoModel(conf, mstate, device="cpu").probs(wave, va, vah)
    for key in ("p_now", "p_future"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=2e-4, rtol=0)


# the attention ops, in the order of the launches the helpers below return
_ATTENTION_OPS = ("flash_alibi", "flash_train_forward", "flash_train_backward")


def _probs_on_card(conf, state):
    """probs of the B=2 x 1 s request on the card, with the attention
    kernels' launches."""
    wave = (0.1 * np.random.default_rng(0).standard_normal((2, 2, 16000))).astype(np.float32)
    before = _build.launch_counts()
    got = VapModel(conf, state, device="cuda").probs(wave)
    launched = _launched(before)
    return got, [launched[op] for op in _ATTENTION_OPS], wave


def _train_step(conf, state, device):
    """One dropout-free train step at B=1 x 1 s: (net, metrics, attention
    launches)."""
    rng = np.random.default_rng(2)
    batch = {"waveform": (0.1 * rng.standard_normal((1, 2, 16000))).astype(np.float32),
             "vad": (rng.random((1, 150, 2)) < 0.5).astype(np.float32)}
    net = VapNet(conf)
    net.load_state_dict(state)
    net.to(device)
    before = _build.launch_counts()
    step = tstep.make_train_step(conf, tstep.make_optimizer(OptConfig(), net))
    metrics = step(net, batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    launched = _launched(before)
    return net, {k: float(v) for k, v in metrics.items()}, [launched[op] for op in _ATTENTION_OPS]


def test_attn_impl_xla_runs_no_attention_kernel(cuda, state):
    """``attn_impl="xla"``: inference and a train step take the dense path on
    the card (no attention launch) and match ``"auto"`` (f32: p within
    2e-4; the step's losses within 1e-5, gradients 1e-4 of each leaf's
    largest, the card-vs-CPU bars)."""
    auto, launches, _ = _probs_on_card(VapConfig(), state)
    assert launches == [14, 0, 0]
    xla, launches, _ = _probs_on_card(VapConfig(attn_impl="xla"), state)
    assert launches == [0, 0, 0]
    for key in ("p_now", "p_future"):
        torch.testing.assert_close(xla[key], auto[key], atol=2e-4, rtol=0)
    net_a, m_a, launches = _train_step(VapConfig(dropout=0.0), state, "cuda")
    assert launches == [0, 14, 14]
    net_x, m_x, launches = _train_step(VapConfig(dropout=0.0, attn_impl="xla"), state, "cuda")
    assert launches == [0, 0, 0]
    for key in m_a:
        assert abs(m_a[key] - m_x[key]) < 1e-5, key
    for (name, p), q in zip(net_a.named_parameters(), net_x.parameters()):
        if p.grad is None:
            assert q.grad is None, name
            continue
        torch.testing.assert_close(q.grad, p.grad, atol=1e-4 * max(float(p.grad.abs().max()), 1e-6),
                                   rtol=0, msg=name)


@pytest.mark.parametrize("heads", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_width_routes_forward_and_train_step(cuda, heads, dtype):
    """Head widths 128, 64 and 32 (2, 4 and 8 heads) run the attention
    kernels (``KERNEL_HEAD_DIMS``), under ``"auto"`` and ``"pallas"``: the
    forward against the CPU at the default config's bars (p 2e-4 in f32,
    2e-3 in bf16), and a dropout-free train step against the CPU's float32
    step (f32: losses 1e-4, gradients 1e-4 of each leaf's largest; bf16
    against f32: losses 5e-3, about a tenth of the bf16 logits' bar of 5e-2
    since the loss averages log-softmax terms over the frames (measured
    1.1e-3 at 8 heads), gradients 0.1, the bf16 slice's bar)."""
    conf = VapConfig(num_heads=heads, dtype=dtype)
    state = params_from_jax(random_params_tree(conf, seed=0), conf)
    got, launches, wave = _probs_on_card(conf, state)
    assert launches == [14, 0, 0]
    want = VapModel(VapConfig(num_heads=heads), state, device="cpu").probs(wave)
    atol = 2e-4 if dtype == "float32" else 2e-3
    for key in ("p_now", "p_future"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=atol, rtol=0)
    pallas, launches, _ = _probs_on_card(VapConfig(num_heads=heads, dtype=dtype, attn_impl="pallas"), state)
    assert launches == [14, 0, 0]
    for key in ("p_now", "p_future"):
        torch.testing.assert_close(pallas[key], got[key], atol=1e-6, rtol=0)
    card, m_card, launches = _train_step(VapConfig(num_heads=heads, dtype=dtype, dropout=0.0), state, "cuda")
    assert launches == [0, 14, 14]
    cpu, m_cpu, _ = _train_step(VapConfig(num_heads=heads, dropout=0.0), state, "cpu")
    loss_bar, grad_rel = (1e-4, 1e-4) if dtype == "float32" else (5e-3, 0.1)
    for key in m_cpu:
        assert math.isfinite(m_card[key]) and abs(m_cpu[key] - m_card[key]) < loss_bar, key
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        if p.grad is None:
            assert q.grad is None, name
            continue
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=grad_rel * max(float(p.grad.abs().max()), 1e-6),
                                   rtol=0, msg=name)


def test_head_width_without_kernels_raises_on_card(cuda):
    """16 heads (head width 16, for which no kernel is built): the forward
    on the card raises under ``"auto"`` and ``"pallas"`` rather than leave
    the kernels, and runs dense attention under ``"xla"``, against the CPU
    at 2e-4."""
    conf = VapConfig(num_heads=16)
    state = params_from_jax(random_params_tree(conf, seed=0), conf)
    for impl in ("auto", "pallas"):
        with pytest.raises(ValueError, match="head width .*got 16"):
            _probs_on_card(VapConfig(num_heads=16, attn_impl=impl), state)
    got, launches, wave = _probs_on_card(VapConfig(num_heads=16, attn_impl="xla"), state)
    assert launches == [0, 0, 0]
    want = VapModel(conf, state, device="cpu").probs(wave)
    for key in ("p_now", "p_future"):
        torch.testing.assert_close(got[key].cpu(), want[key], atol=2e-4, rtol=0)


def test_from_torch_state_dict_on_card_equals_cpu(cuda, state, tmp_path):
    """A reference-format ``.pt`` loads to the same weights on the card as
    on the CPU."""
    from voiceactivityprojection_tpu_torch.models.checkpoint import export_vap_state_dict

    path = tmp_path / "w.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in export_vap_state_dict(state).items()}, path)
    card = VapModel.from_torch_state_dict(str(path), VapConfig(), device="cuda").net.state_dict()
    cpu = VapModel.from_torch_state_dict(str(path), VapConfig(), device="cpu").net.state_dict()
    assert set(card) == set(cpu) == set(state)
    for k, v in cpu.items():
        assert card[k].is_cuda
        torch.testing.assert_close(card[k].cpu(), v, atol=0, rtol=0)
        torch.testing.assert_close(v, state[k], atol=0, rtol=0)


def test_step_extraction_on_card_matches_cpu(cuda, state):
    """Windows of 5 s every 1 s, four to a call, on 7.3 s plus an odd
    sample count: the card's stitched outputs and loss against the CPU's
    (float32, the vs-CPU bar 2e-4), K1, K2 and attention launched once per
    call of four windows."""
    from voiceactivityprojection_tpu_torch.inference.extraction import VapExtractor

    rng = np.random.default_rng(3)
    n = int(16000 * 7.3) + 77
    wave = (0.1 * rng.standard_normal((1, 2, n))).astype(np.float32)
    vad = (rng.random((1, n // 320 + 100, 2)) < 0.5).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        ex = VapExtractor(VapModel(VapConfig(), state, device=device), 4.0, 1.0, chunk_batch=4)
        before = _build.launch_counts()
        outs[device] = ex.step_extraction(wave, vad=vad)
        if device == "cuda":
            calls = 1  # 3 windows and the tail: one call of four
            launched = _launched(before)
            assert [launched[op] for op in ("conv_stack", "gru_downsample", "flash_alibi")] == [
                5 * calls, calls, 14 * calls]
    assert outs["cuda"]["p_now"].shape == (1, int(n / 16000 * 50), 2)
    for key in ("p_now", "p_future", "vad"):
        np.testing.assert_allclose(outs["cuda"][key], outs["cpu"][key], atol=2e-4, err_msg=key)
    np.testing.assert_allclose(outs["cuda"]["loss"], outs["cpu"]["loss"], atol=1e-3)


@pytest.mark.parametrize("dtype, bar", [("float32", 2e-4), ("bfloat16", 2e-3)])
def test_evaluate_on_card_matches_cpu(cuda, state, dtype, bar, tmp_path):
    """``evaluate()`` over 3 windows of 20 s in batches of 2 and 1: on the
    card in float32 and bfloat16 against the CPU's float32, regions and
    targets identical, pooled predictions and losses within the run CLI's
    bars (2e-4, 2e-3), metrics equal apart from predictions within the bar
    of a threshold; K1 x 5, K2 x 1 and attention x 14 per batch, nothing
    else."""
    import os
    import subprocess
    import sys

    from voiceactivityprojection_tpu_torch.config import EventConfig
    from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset, VapDataLoader
    from voiceactivityprojection_tpu_torch.train import evaluation as teval

    from _torch_eval import compare_evaluations, pooled, recording

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "examples/make_synthetic_corpus.py", "--out", str(tmp_path), "--n", "3",
                    "--duration", "25"], cwd=root, check=True, capture_output=True, timeout=300)
    with open(tmp_path / "all.csv", "w") as f:
        f.write("audio_path,vad_path,start,end\n" + "".join(
            f"{tmp_path}/s{i:03d}.wav,{tmp_path}/s{i:03d}_vad.json,,\n" for i in range(3)))
    counted = ("conv_stack", "gru_downsample", "flash_alibi", "gru_recurrence", "gru_backward",
               "flash_train_forward", "flash_train_backward", "flash_alibi_offset", "conv01")
    runs = {}
    for device, dt in (("cuda", dtype), ("cpu", "float32")):
        model = VapModel(VapConfig(dtype=dt), state, device=device)
        loader = VapDataLoader(SlidingWindowDataset(str(tmp_path / "all.csv")), batch_size=2, shuffle=False,
                               drop_last=False)
        before = _build.launch_counts()
        with recording(teval) as seen:
            result = teval.evaluate(model, loader, EventConfig(), out_dir=str(tmp_path / device))
        torch.cuda.synchronize()
        launched = _launched(before)
        runs[device] = (result, seen[0], {op: launched[op] for op in counted})
    (got, t, launches), (want, c, _) = runs["cuda"], runs["cpu"]
    assert launches == dict(dict.fromkeys(counted, 0), conv_stack=10, gru_downsample=2, flash_alibi=28)
    assert t.events == c.events and t.debts == c.debts and len(t.events) == 2
    np.testing.assert_allclose(t.vap_losses, c.vap_losses, atol=bar, rtol=0)
    report = compare_evaluations(got, want, pooled(t), pooled(c), bar, bar)
    assert not report["mismatches"], report


# ------------------------------------------------- parallelism at one rank --
def test_dp_and_tp_at_world_size_one_on_nccl(cuda, state, tmp_path):
    """A process group of one rank on NCCL: the data-parallel step (its
    gradient and metric all-reduces) and the tensor-parallel step (the
    Megatron reduce points of every attention and FFN block, over a model
    group of one) against the plain step, float32 at dropout 0, at the
    card's step bars: losses 1e-5, gradients 1e-4 of each leaf's largest,
    updates 5e-7 where the gradient is clear of 2e-4 of it and of 1e-6 (the
    training kernels' backward sums in no fixed order, and Adam turns a
    gradient near 0 into an update of its sign: one element of 327,680 moved
    by 1.6e-5 between two runs on an H100)."""
    import torch.distributed as dist

    from voiceactivityprojection_tpu_torch.parallel.mesh import ProcessLayout, init_distributed
    from voiceactivityprojection_tpu_torch.parallel.tp import shard_params_tp

    if not dist.is_nccl_available():
        pytest.skip("this torch has no NCCL")
    conf = VapConfig(dropout=0.0, channel_layers=1, cross_layers=1)
    g = np.random.default_rng(0)
    batch = {"waveform": torch.from_numpy((0.1 * g.standard_normal((2, 2, 32000))).astype(np.float32)),
             "vad": torch.from_numpy((g.random((2, 200, 2)) < 0.5).astype(np.float32))}
    init_distributed("cuda", init_method=f"file://{tmp_path}/store", rank=0, world_size=1, timeout_s=60)
    try:
        results = []
        for mode in ("plain", "dp", "tp"):
            net = VapNet(conf)
            net.load_state_dict(params_from_jax(random_params_tree(conf, seed=0), conf))
            net.to(cuda)
            layout = ProcessLayout() if mode == "dp" else None
            if mode == "tp":
                shard_params_tp(net, 0, 1, dist.group.WORLD)
            opt = tstep.make_optimizer(OptConfig(), net, conf.freeze_encoder)
            m = tstep.make_train_step(conf, opt, layout)(net, batch, torch.Generator().manual_seed(0))
            results.append(({k: float(v) for k, v in m.items()},
                            {k: (p.detach().cpu(), p.grad.cpu()) for k, p in net.named_parameters()
                             if p.grad is not None}))
    finally:
        dist.destroy_process_group()
    (m0, w0) = results[0]
    for m, w in results[1:]:
        for k in m0:
            assert abs(m[k] - m0[k]) <= 1e-5, (k, m[k], m0[k])
        assert set(w) == set(w0)
        for k, (p0, g0) in w0.items():
            p, g = w[k]
            scale = float(g0.abs().max())
            torch.testing.assert_close(g, g0, atol=1e-4 * scale, rtol=0)
            clear = g0.abs() > max(1e-6, 2e-4 * scale)
            torch.testing.assert_close(p[clear], p0[clear], atol=5e-7, rtol=0)
