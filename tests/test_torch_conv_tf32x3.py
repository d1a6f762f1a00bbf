"""PyTorch port: the float32 design of K1's conv1-conv4
(``csrc/conv_stack.cu`` ``conv_cn_relu_tf32x3_kernel``, 3xTF32 on
``wgmma``), checked on the CPU where no kernel runs.

- ``cvt.rna.tf32.f32`` modelled with int32 bit operations, and the split
  v = hi + lo that the kernel and ``split_tf32_kmajor_kernel`` make;
- the kernel's arithmetic emulated at ``VapConfig()`` widths: each of
  conv1-conv4 as x_hi w_hi + x_hi w_lo + x_lo w_hi (the products of tf32
  values exact, their sum taken in float64, then rounded to f32 as the f32
  accumulators hold it), ChannelNorm and ReLU in f32, held to the stack in
  float64 and to the JAX package's f32 ``_reference_stack`` at the card's
  float32 bar (1e-4), with the margin stated; one-pass TF32 is held to the
  same inputs to show what the bar refuses;
- the same with the tensor cores' accumulation modelled: each m64nNk8
  product added to the f32 accumulator and the sum rounded toward zero,
  768 times a conv1 output in the kernel's order; the card's error vs the
  plain version (4-5e-5) is this model's, and it stays under the bar;
- the route rule and the kernel's constants against the CUDA source;
- CPU tensors take the plain version and count no launch.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from voiceactivityprojection_tpu.models.encoder import init_encoder
from voiceactivityprojection_tpu.ops.conv_stack_fused import _reference_stack
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
from voiceactivityprojection_tpu_torch.ops.conv import channel_norm, conv1d

pytestmark = pytest.mark.encoder

torch.set_num_threads(2)
SOURCE = (_build.CSRC_DIR / "conv_stack.cu").read_text()
F32_BAR = 1e-4  # chip_smoke.py F32_TOL["conv_stack"], tests/test_torch_cuda.py


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: v rounded to 10 mantissa bits, nearest, ties
    away from zero: add half of the 13 dropped bits to the magnitude's bit
    pattern (the sign bit is apart, so the carry rounds away from zero),
    then clear them."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32_rna(v)
    return hi, tf32_rna(v.float() - hi)


def test_rna_rounds_to_nearest_ties_away():
    one = 1.0
    cases = {one + 2.0 ** -11: one + 2.0 ** -10,  # a tie: away from zero
             -(one + 2.0 ** -11): -(one + 2.0 ** -10),
             one + 2.0 ** -12: one,  # under half: down
             one + 3 * 2.0 ** -12: one + 2.0 ** -10,  # over half: up
             one + 3 * 2.0 ** -11: one + 2.0 ** -9,  # a tie at an odd last bit: away
             0.0: 0.0}
    got = tf32_rna(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == list(cases.values())


def test_split_is_exact_and_leaves_two_to_the_minus_22():
    """hi has its low 13 bits clear and |v - hi| <= 2^-11 |v|; v - hi is
    exact in f32, and its own rounding leaves at most 2^-22 |v|: what the
    three products drop besides x_lo w_lo."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000).astype(np.float32)) * 10.0
    hi, lo = split(v)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all()) and bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    v64, hi64, lo64 = v.double(), hi.double(), lo.double()
    assert bool(((v64 - hi64).abs() <= 2.0 ** -11 * v64.abs()).all())
    assert bool(((v64 - hi64 - lo64).abs() <= 2.0 ** -22 * v64.abs()).all())


@pytest.fixture(scope="module")
def layers():
    enc = jax.tree.map(np.asarray, jax.jit(init_encoder, static_argnums=1)(jax.random.key(0), 256))
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    return enc, [(t(l["conv"]["w"]), t(l["conv"]["b"]), t(l["norm"]["w"]), t(l["norm"]["b"]))
                 for l in enc["gEncoder"]]


def _emulated_stack(layers, x, passes):
    """conv0 in f32 as the CUDA-core kernel computes it; conv1-conv4 as the
    tf32 kernel: ``passes`` 3 sums x_hi w_hi + x_hi w_lo + x_lo w_hi, 1 only
    x_hi w_hi (one-pass TF32), in float64, rounded to f32 with the bias; then
    ChannelNorm and ReLU in f32."""
    (w, b, nw, nb), (_, s, p) = layers[0], k1.CPC_CONV_SPECS[0]
    z = torch.relu(channel_norm(conv1d(x[..., None], w, b, stride=s, padding=(p, p)), nw, nb))
    for (w, b, nw, nb), (_, s, p) in zip(layers[1:], k1.CPC_CONV_SPECS[1:]):
        (x_hi, x_lo), (w_hi, w_lo) = split(z), split(w)
        c = lambda a, bb: conv1d(a.double(), bb.double(), None, stride=s, padding=(p, p))
        y = c(x_hi, w_hi) if passes == 1 else c(x_hi, w_hi) + c(x_hi, w_lo) + c(x_lo, w_hi)
        z = torch.relu(channel_norm((y + b.double()).float(), nw, nb))
    return z


def test_3xtf32_stack_matches_float64_and_jax(layers):
    """At ``VapConfig()`` widths, R = 2 x 16,000 samples (conv1 contracts
    2,048 terms a position): the 3xTF32 stack within the f32 bar of the
    stack in float64 and of JAX's f32 ``_reference_stack``; measured 7.3e-7
    and 2.1e-6, under a tenth of the bar. One-pass TF32 on the same inputs
    lands 2.4e-3 from float64, 24 times the bar: the reason for three
    products."""
    enc, lw = layers
    x = torch.from_numpy((0.1 * np.random.default_rng(3).standard_normal((2, 16_000))).astype(np.float32))
    got = _emulated_stack(lw, x, passes=3)
    f64 = k1.plain_layers([tuple(t.double() for t in l) for l in lw], x.double()[..., None], k1.CPC_CONV_SPECS)
    jax_f32 = torch.from_numpy(np.array(jax.jit(_reference_stack)(jax.tree.map(jnp.asarray, enc), jnp.asarray(x))))
    assert got.shape == f64.shape == jax_f32.shape == (2, 100, 256)
    err64 = float((got.double() - f64).abs().max())
    err_jax = float((got - jax_f32).abs().max())
    assert err64 <= F32_BAR / 10 and err_jax <= F32_BAR / 10, (err64, err_jax)
    one_pass = float((_emulated_stack(lw, x, passes=1).double() - f64).abs().max())
    assert one_pass > F32_BAR, one_pass


def _round_toward_zero(d: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = d.float()
    return torch.where(f.double().abs() > d.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _truncating_stack(layers, x):
    """conv1-conv4 as the card sums them: im2col rows in the kernel's
    contraction order (tap, then input channel), 8 terms a k-step, the three
    products of a k-step in the kernel's order (x_lo w_hi, x_hi w_lo,
    x_hi w_hi), each added to the f32 accumulator in float64 and the sum
    rounded toward zero; conv0, ChannelNorm and ReLU in f32."""
    (w, b, nw, nb), (_, s, p) = layers[0], k1.CPC_CONV_SPECS[0]
    z = torch.relu(channel_norm(conv1d(x[..., None], w, b, stride=s, padding=(p, p)), nw, nb))
    for (w, b, nw, nb), (k, s, p) in zip(layers[1:], k1.CPC_CONV_SPECS[1:]):
        cols = F.pad(z.transpose(1, 2), (p, p)).unfold(2, k, s)  # (R, C, n_out, k)
        R, C, n_out, _ = cols.shape
        (xh, xl), (wh, wl) = split(cols.permute(0, 2, 3, 1).reshape(R * n_out, k * C)), split(w.reshape(k * C, -1))
        terms = [(a.double(), bb.double()) for a, bb in ((xl, wh), (xh, wl), (xh, wh))]
        acc = torch.zeros(R * n_out, w.shape[-1])
        for k0 in range(0, k * C, 8):
            for a, bb in terms:
                acc = _round_toward_zero(acc.double() + a[:, k0:k0 + 8] @ bb[k0:k0 + 8])
        z = torch.relu(channel_norm((acc + b).reshape(R, n_out, -1), nw, nb))
    return z


def test_truncating_accumulation_stays_under_the_bar(layers):
    """The 3xTF32 stack with the accumulator rounded toward zero after each
    product (R = 2 x 16,000, conv1's 2,048 terms: 768 roundings an output)
    lands 5.2e-5 from float64 and from JAX's f32 stack, as the card's kernel
    lands 4.4e-5 (R = 8) to 4.9e-5 (R = 128) from its plain version, and 72
    times the exact sums' 7.3e-7: the accumulation, not the split, sets the
    error. Under the bar, with half of it to spare."""
    enc, lw = layers
    x = torch.from_numpy((0.1 * np.random.default_rng(3).standard_normal((2, 16_000))).astype(np.float32))
    got = _truncating_stack(lw, x)
    f64 = k1.plain_layers([tuple(t.double() for t in l) for l in lw], x.double()[..., None], k1.CPC_CONV_SPECS)
    jax_f32 = torch.from_numpy(np.array(jax.jit(_reference_stack)(jax.tree.map(jnp.asarray, enc), jnp.asarray(x))))
    err64 = float((got.double() - f64).abs().max())
    exact = float((_emulated_stack(lw, x, passes=3).double() - f64).abs().max())
    assert err64 <= F32_BAR and float((got - jax_f32).abs().max()) <= F32_BAR, err64
    assert err64 > 10 * exact, (err64, exact)


def test_route_and_constants_match_the_cuda_source():
    """conv1-conv4 take the tensor-core kernel of their dtype, conv0 the
    CUDA cores; the kernel's block, chunk and stage sizes as its header
    defines them, within a CTA's 232,448 bytes of shared memory."""
    assert k1.kernel_for(torch.float32, 256) == "wgmma 3xtf32"
    assert k1.kernel_for(torch.bfloat16, 256) == "wgmma bfloat16"
    assert k1.kernel_for(torch.float32, 1) == k1.kernel_for(torch.bfloat16, 1) == "cuda cores"
    const = lambda name: re.search(rf"constexpr int {name} = ([^;]+);", SOURCE).group(1)
    assert const("TF_WG") == "2" and const("TF_KC") == "32" and const("TF_B_BYTES") == "BN * 128"
    stage = 2 * 8192 + 2 * 256 * 128
    assert const("TF_STAGE") == "TF_WG * wg::TILE_BYTES + 2 * TF_B_BYTES" and stage == 81_920
    assert re.search(r"TF_SMEM = 2 \* TF_STAGE \+ 1024;", SOURCE) and 2 * stage + 1024 <= 232_448
    # three products a k-step and channel group, none of them one-pass
    body = SOURCE[SOURCE.index("conv_cn_relu_tf32x3_kernel("):SOURCE.index('extern "C"')]
    assert len(re.findall(r"mma_tf32_rs\(acc\[g\], (alo|ahi)\[kk\], wg::desc_k\((Bh|Bl)", body)) == 3
    assert {m for m in re.findall(r"mma_tf32_rs\(acc\[g\], (\w+)\[kk\], wg::desc_k\((\w+)", body)} == {
        ("ahi", "Bh"), ("ahi", "Bl"), ("alo", "Bh")}


def test_cpu_tensors_take_the_plain_version_uncounted(layers):
    _, lw = layers
    x = torch.from_numpy((0.1 * np.random.default_rng(4).standard_normal((1, 3200))).astype(np.float32))
    before = (k1.fused_conv_stack.launches, dict(k1.fused_conv_stack.by_kernel))
    assert torch.equal(k1.fused_conv_stack(lw, x), k1.reference_stack(lw, x))
    assert (k1.fused_conv_stack.launches, k1.fused_conv_stack.by_kernel) == before
