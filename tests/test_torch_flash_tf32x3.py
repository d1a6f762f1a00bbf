"""PyTorch port: the float32 design of the attention kernels on Hopper's
tensor cores (``csrc/flash_alibi.cu`` ``flash_alibi_tf32x3_kernel``, K4/K5/K10;
``csrc/flash_alibi_train.cu`` ``flash_train_fwd_tf32x3_kernel``, K6, and
``flash_train_dkv_tf32x3_kernel`` and ``flash_train_dq_tf32x3_kernel``,
K7/K8), checked on the CPU where no kernel runs.

Each float32 operand is split into tf32 hi and lo (``tf32_rna``, ``split``
of ``tests/test_torch_conv_tf32x3.py``) and a product is taken as A_lo B_hi
+ A_hi B_lo + A_hi B_hi, k-steps of 8, each product added to the f32
accumulator and the sum rounded toward zero, as the tensor cores sum.
The emulations run the kernels' order at ``VapConfig()`` widths (H=4,
Dh=64, scale 1/16, the ALiBi slopes), randn inputs:

- the forward on its heaviest (last) query tile at T=1000 and on the
  ragged last tile of an offset shard: S per key tile, the online softmax
  in f32 (exponentials correctly rounded, as ``expf``), O += P V straight in
  the accumulator across key tiles; held to JAX's f32 ``_dense_reference``
  and to float64 at the forward bar (5e-6), and one-pass TF32 shown over
  it;
- the dK/dV kernel's first key tile (the one every query tile reaches) at
  T=1000: S^T, dP^T, then dV += Y^T dO and dK += dS^T Q with each query
  tile's products in a fresh accumulator added by FFMA, and with every
  product straight into one accumulator; held to JAX's gradient of
  ``_dense_reference`` and to float64 at the backward bar (5e-5), the
  fresh sums under it, the direct ones at least four times further from
  the exact gradient;
- dP = dO V^T, whose truncated sum moves dS's row sums off zero: summed
  a k-step at a time with round-to-nearest adds (the kernels' design), its
  row sums stay at plain f32's level; and the whole backward, emulated in
  a frozen train step at ``VapConfig()`` widths, keeps every gradient
  within the card's step bar of dense autograd, where dP summed straight
  in the accumulator lands five times further;
- the kernels' constants, the register-fragment permutation and the dtype
  dispatch against the CUDA sources.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voiceactivityprojection_tpu.ops import flash_alibi_train as jft
from voiceactivityprojection_tpu.ops.flash_alibi import _dense_reference
from voiceactivityprojection_tpu_torch import VapConfig
from voiceactivityprojection_tpu_torch.config import OptConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax, random_params_tree
from voiceactivityprojection_tpu_torch.models.vap import VapNet
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import attention as attn_ops
from voiceactivityprojection_tpu_torch.ops import flash_alibi as k4
from voiceactivityprojection_tpu_torch.ops import flash_alibi_train as ft
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes
from voiceactivityprojection_tpu_torch.train import step as tstep

from test_torch_conv_tf32x3 import _round_toward_zero, split

pytestmark = pytest.mark.transformer

torch.set_num_threads(2)
FWD = (_build.CSRC_DIR / "flash_alibi.cu").read_text()
TRAIN = (_build.CSRC_DIR / "flash_alibi_train.cu").read_text()
WGMMA = (_build.CSRC_DIR / "wgmma.cuh").read_text()
FWD_BAR = 5e-6  # chip_smoke.py F32_TOL["flash_alibi"], ["flash_alibi_offset"]
BWD_BAR = 5e-5  # chip_smoke.py F32_TOL["flash_train_backward"]
H, DH, TILE = 4, 64, 64
SCALE = 1.0 / 16  # 1 / sqrt(VapConfig().dim)
SMEM_LIMIT = 232_448  # a CTA's dynamic shared memory on the H100
STEP_BAR = 1e-4  # chip_smoke.py TRAIN_VS_CPU_TOL["grad_rel"], tests/test_torch_cuda.py


def _product(acc, a, b, passes=3):
    """acc (f32) + a @ b over the last axis of a, as the tensor cores sum it:
    k-steps of 8 columns, each step's products (A_lo B_hi, A_hi B_lo,
    A_hi B_hi; one pass: A_hi B_hi) exact in float64, each added to the f32
    accumulator and the sum rounded toward zero."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = _round_toward_zero(acc.double() + x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double())
    return acc


def _product_nearest(acc, a, b):
    """acc + a @ b with each k-step's three products summed in a fresh
    accumulator (rounded toward zero) and added to acc in f32, rounded to
    nearest: ``tile_abt_tf32x3_nearest``."""
    (ah, al), (bh, bl) = split(a), split(b)
    for k0 in range(0, a.shape[-1], 8):
        fresh = torch.zeros_like(acc)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            fresh = _round_toward_zero(fresh.double() + x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double())
        acc = acc + fresh
    return acc


def _exp(x):
    """exp in f32, correctly rounded (the card's expf is within 2 ulp)."""
    return torch.exp(x.double()).float()


def _rows(t, r0, n):
    """Rows [r0, r0 + n) of (H, T, Dh), zeros past T."""
    out = torch.zeros(t.shape[0], n, t.shape[2])
    got = t[:, r0:r0 + n]
    out[:, :got.shape[1]] = got
    return out


def _forward_tile(q, k, v, q0, offset, passes=3):
    """The f32 kernel on query rows [q0, q0 + 64) of q (H, Tq, Dh) at global
    offset ``offset`` of k, v (H, Tk, Dh): its key walk, f32 softmax and
    products; returns the tile's (H, rows, Dh) output."""
    Tq, Tk = q.shape[1], k.shape[1]
    rows = min(TILE, Tq - q0)
    slopes = alibi_slopes(H)
    qt = _rows(q, q0, TILE)
    gi = offset + q0 + torch.arange(TILE)
    m = torch.full((H, TILE), float("-inf"))
    l = torch.zeros(H, TILE)
    o = torch.zeros(H, TILE, DH)
    for kt in range(min(Tk - 1, offset + q0 + rows - 1) // TILE + 1):
        k0 = kt * TILE
        s = _product(torch.zeros(H, TILE, TILE), qt, _rows(k, k0, TILE).transpose(1, 2), passes)
        j = k0 + torch.arange(TILE)
        s = s * SCALE + slopes[:, None, None] * (j[None, None, :] - gi[None, :, None]).float()
        s = s.masked_fill(j[None, None, :] > gi[None, :, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        corr = _exp(m - mu)
        p = _exp(s - mu[..., None])
        l = l * corr + p.sum(-1)
        m = m_new
        o = _product(o * corr[..., None], p, _rows(v, k0, TILE), passes)
    return (o / l[..., None])[:, :rows]


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _jax_rows(q_full, k, v, r0, n):
    """JAX's f32 dense attention on the whole (H, T, Dh) timeline, rows
    [r0, r0 + n)."""
    args = [jnp.asarray(t.numpy()[None]) for t in (q_full, k, v)]
    out = _dense_reference(*args, jnp.asarray(alibi_slopes(H).numpy()), SCALE)
    return torch.from_numpy(np.array(out)[0, :, r0:r0 + n])


@pytest.mark.parametrize("case", ["k4_t1000", "k10_ragged_shard"])
def test_3xtf32_forward_matches_jax_and_float64(case):
    """K4 at T=1000 on its last query tile (rows 960-999, 16 key tiles), and
    K10 on the ragged last tile (rows 384-399) of Tq=400 query rows at
    offset 937 of Tk=1337 keys (21 key tiles): the emulated kernel within
    the forward bar of JAX's f32 dense attention and of float64, with at
    least a fifth of the bar to spare (measured 6.1e-7 and 5.4e-7 from
    float64, 6.7e-7 and 5.5e-7 from JAX, which lies 2.5e-7 and 1.6e-7 from
    float64 itself); one-pass TF32 on the same inputs lands 5.5e-4 and
    7.0e-4 from float64, over a hundred times the bar."""
    rng = np.random.default_rng(0 if case == "k4_t1000" else 1)
    Tk, Tq, offset = (1000, 1000, 0) if case == "k4_t1000" else (1337, 400, 937)
    k, v, q_full = (_randn(rng, H, Tk, DH) for _ in range(3))
    q = q_full[:, offset:offset + Tq]
    q0 = (Tq - 1) // TILE * TILE
    rows = Tq - q0
    got = _forward_tile(q, k, v, q0, offset)
    f64 = k4.dense_offset_reference(q[None].double(), k[None].double(), v[None].double(),
                                    alibi_slopes(H).double(), SCALE, offset)[0, :, q0:]
    want_jax = _jax_rows(q_full, k, v, offset + q0, rows)
    assert got.shape == f64.shape == want_jax.shape == (H, rows, DH)
    err64 = float((got.double() - f64).abs().max())
    err_jax = float((got - want_jax).abs().max())
    assert err64 <= 0.8 * FWD_BAR and err_jax <= 0.8 * FWD_BAR, (err64, err_jax)
    one_pass = float((_forward_tile(q, k, v, q0, offset, passes=1).double() - f64).abs().max())
    assert one_pass > 10 * FWD_BAR, one_pass


def _train_forward_tile(q, k, v, q0, seed, rate, permuted_mask=False, nearest_s=False):
    """The f32 training forward on query rows [q0, q0 + 64) of q, k, v
    (H, T, Dh; batch 1, so bh is the head): the inference kernel's walk and
    products, with the row sum l taken before the mask and p zeroed where
    the hash of (bh, row, key) drops it, the key the accumulator column's
    own (or, ``permuted_mask``, the k-position ``kpos`` it holds in the A
    fragment); S summed straight in the accumulator or, ``nearest_s`` (the
    kernel at Dh = 128), a k-step at a time to nearest. Returns the tile's
    out (H, rows, Dh) and lse (H, rows)."""
    H, T, DH = q.shape
    rows = min(TILE, T - q0)
    slopes = alibi_slopes(H)
    thresh = ft.rate_threshold(rate)
    inv = 1.0 / (1.0 - rate)
    kpos = lambda c: (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2)
    qt = _rows(q, q0, TILE)
    gi = q0 + torch.arange(TILE)
    m = torch.full((H, TILE), float("-inf"))
    l = torch.zeros(H, TILE)
    o = torch.zeros(H, TILE, DH)
    for kt in range((q0 + rows - 1) // TILE + 1):
        k0 = kt * TILE
        sum_s = _product_nearest if nearest_s else _product
        s = sum_s(torch.zeros(H, TILE, TILE), qt, _rows(k, k0, TILE).transpose(1, 2))
        j = k0 + torch.arange(TILE)
        s = s * SCALE + slopes[:, None, None] * (j[None, None, :] - gi[None, :, None]).float()
        s = s.masked_fill(j[None, None, :] > gi[None, :, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        corr = _exp(m - mu)
        p = _exp(s - mu[..., None])
        l = l * corr + p.sum(-1)
        m = m_new
        key = k0 + torch.tensor([kpos(c) for c in range(TILE)]) if permuted_mask else j
        keep = ft.hash_keep(torch.arange(H)[:, None, None], gi[None, :, None], key[None, None, :], seed, thresh)
        p = torch.where(keep, p, torch.zeros(()))
        o = _product(o * corr[..., None], p, _rows(v, k0, TILE))
    out = o * inv / l[..., None]
    return out[:, :rows], (m + torch.log(l))[:, :rows]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_3xtf32_train_forward_with_dropout_matches_jax_and_float64(rate):
    """K6 in float32 at T=1000 (H=4, Dh=64, the frozen step's shape a
    batch row) on its last query tile (rows 960-999, 16 key tiles), at the
    step's rate 0.1 and at 0.5: the emulated kernel's out and lse within
    the forward bar (5e-6) of JAX's ``_flash_train_forward`` in interpret
    mode and of the float64 plain forward, with two thirds of the bar to
    spare (measured out 6.6e-7 / 1.37e-6 and lse 4.3e-7 from float64 at
    rate 0.1 / 0.5: the kept p are scaled by 1 / (1 - rate), up to 2). The
    keep mask read at the A fragment's permuted k-positions instead of each
    score's own key lands 1.07 / 2.24 off."""
    rng = np.random.default_rng(6)
    T, seed = 1000, 424242
    q, k, v = (_randn(rng, H, T, DH) for _ in range(3))
    q0 = (T - 1) // TILE * TILE
    out, lse = _train_forward_tile(q, k, v, q0, seed, rate)
    f64_out, f64_lse = ft.train_forward_reference(q[None].double(), k[None].double(), v[None].double(),
                                                  alibi_slopes(H).double(), seed, SCALE, rate)
    jargs = [jnp.asarray(t.numpy()[None]) for t in (q, k, v)]
    j_out, j_lse = jft._flash_train_forward(*jargs, jnp.asarray(alibi_slopes(H).numpy()),
                                            jnp.asarray(seed, jnp.int32), SCALE, rate)
    j_out = torch.from_numpy(np.array(j_out))[0, :, q0:]
    j_lse = torch.from_numpy(np.array(j_lse)).reshape(H, T)[:, q0:]
    f64_out, f64_lse = f64_out[0, :, q0:], f64_lse.reshape(H, T)[:, q0:]
    errs = {"out_f64": float((out.double() - f64_out).abs().max()),
            "lse_f64": float((lse.double() - f64_lse).abs().max()),
            "out_jax": float((out - j_out).abs().max()), "lse_jax": float((lse - j_lse).abs().max())}
    assert max(errs.values()) <= FWD_BAR / 3, errs
    wrong, _ = _train_forward_tile(q, k, v, q0, seed, rate, permuted_mask=True)
    assert float((wrong.double() - f64_out).abs().max()) > 1000 * FWD_BAR


def test_3xtf32_train_forward_sums_s_to_nearest_at_dh128():
    """K6 at Dh = 128 (2 heads of 128, rate 0.5, the last query tile of
    T=1000): S's 16 k-steps summed straight in the truncating accumulator
    land at least three times as far from float64 as summed a k-step at a
    time to nearest (the kernel at Dh = 128), which keeps out within a third
    of the forward bar (measured 4.7e-6 straight, 9.7e-7 to nearest; on the
    H100 the straight sum read 5.0e-6 against the kernel's plain version at
    T=3000, over the bar)."""
    rng = np.random.default_rng(7)
    T, seed, rate = 1000, 31337, 0.5
    q, k, v = (_randn(rng, 2, T, 128) for _ in range(3))
    q0 = (T - 1) // TILE * TILE
    f64, _ = ft.train_forward_reference(q[None].double(), k[None].double(), v[None].double(),
                                        alibi_slopes(2).double(), seed, SCALE, rate)
    err = {mode: float((_train_forward_tile(q, k, v, q0, seed, rate, nearest_s=mode == "nearest")[0].double()
                        - f64[0, :, q0:]).abs().max()) for mode in ("straight", "nearest")}
    assert err["nearest"] <= FWD_BAR / 3 and err["straight"] >= 3 * err["nearest"], err


def _dkv_first_key_tile(q, k, v, do, lse, delta, fresh):
    """The dK/dV kernel on key tile 0 (keys 0-63, which every query tile
    reaches) at rate 0: per query tile S^T = K Q^T and dP^T = V dO^T, W =
    exp(S^T scale + bias - lse), dS^T = W (dP^T - delta); dV += W dO and
    dK += dS^T Q, each tile's products in a fresh accumulator added in f32
    (``fresh``) or all straight into one accumulator. Returns (dk, dv)."""
    T = q.shape[1]
    slopes = alibi_slopes(H)
    kt, vt = _rows(k, 0, TILE), _rows(v, 0, TILE)
    j = torch.arange(TILE)
    dk = torch.zeros(H, TILE, DH)
    dv = torch.zeros(H, TILE, DH)
    for q0 in range(0, T, TILE):
        qt, dot = _rows(q, q0, TILE), _rows(do, q0, TILE)
        gi = q0 + torch.arange(TILE)
        lse_t, delta_t = _rows(lse[..., None], q0, TILE)[..., 0], _rows(delta[..., None], q0, TILE)[..., 0]
        s_t = _product(torch.zeros(H, TILE, TILE), kt, qt.transpose(1, 2))
        dp_t = _product(torch.zeros(H, TILE, TILE), vt, dot.transpose(1, 2))
        bias = slopes[:, None, None] * (j[None, :, None] - gi[None, None, :]).float()
        valid = (j[:, None] <= gi[None, :]) & (gi[None, :] < T)
        w = torch.where(valid, _exp(s_t * SCALE + bias - lse_t[:, None, :]), torch.zeros(()))
        ds = w * (dp_t - delta_t[:, None, :])
        if fresh:
            dv = dv + _product(torch.zeros(H, TILE, DH), w, dot)
            dk = dk + _product(torch.zeros(H, TILE, DH), ds, qt)
        else:
            dv = _product(dv, w, dot)
            dk = _product(dk, ds, qt)
    return SCALE * dk, dv


def test_3xtf32_dkv_fresh_accumulators_stay_under_the_bar():
    """T=1000, rate 0, key tile 0 over its 16 query tiles: with each query
    tile's products in a fresh accumulator (the kernel's design) dK and dV
    lie within a fifth of the backward bar of JAX's f32 gradient of
    ``_dense_reference`` and of float64 (measured: dK 2.8e-6, dV 4.2e-6
    from float64; 5.5e-6 from JAX, which lies 2.4e-6 from float64 itself);
    with every product straight into one accumulator they drift at least
    four times as far (measured 2.5e-5 and 4.8e-5, dV at the bar's edge:
    the truncations of 384 additions an element, |dV| up to 4). lse and
    delta come from the plain f32 forward, as the kernel gets them."""
    rng = np.random.default_rng(2)
    T = 1000
    q, k, v, do = (_randn(rng, H, T, DH) for _ in range(4))
    slopes = alibi_slopes(H)
    s = (q.double() @ k.double().transpose(1, 2)) * SCALE
    i = torch.arange(T)
    s = (s + slopes.double()[:, None, None] * (i[None, :] - i[:, None])).masked_fill(i[None, :] > i[:, None],
                                                                                      float("-inf"))
    lse = torch.logsumexp(s, -1).float()
    out = k4.dense_reference(q[None], k[None], v[None], slopes, SCALE)[0]
    delta = (do * out).sum(-1)
    leaves = [t.double()[None].requires_grad_() for t in (q, k, v)]
    f64 = torch.autograd.grad(k4.dense_reference(*leaves, slopes.double(), SCALE), leaves, do.double()[None])
    want64 = [g[0, :, :TILE] for g in f64[1:]]  # dk, dv of keys 0-63

    def loss(q_, k_, v_):
        return jnp.sum(_dense_reference(q_, k_, v_, jnp.asarray(slopes.numpy()), SCALE) * do.numpy()[None])

    jgrads = jax.grad(loss, argnums=(1, 2))(*(jnp.asarray(t.numpy()[None]) for t in (q, k, v)))
    want_jax = [torch.from_numpy(np.array(g)[0, :, :TILE]) for g in jgrads]

    errs = {}
    for mode in ("fresh", "direct"):
        got = _dkv_first_key_tile(q, k, v, do, lse, delta, fresh=mode == "fresh")
        errs[mode] = max(float((g.double() - w).abs().max()) for g, w in zip(got, want64))
        if mode == "fresh":
            err_jax = max(float((g - w).abs().max()) for g, w in zip(got, want_jax))
            assert errs[mode] <= BWD_BAR / 5 and err_jax <= BWD_BAR / 5, (errs[mode], err_jax)
    assert errs["direct"] >= 4 * errs["fresh"], errs


def test_permuted_fragments_keep_the_product():
    """``acc_to_tf32x3`` hands register f of k-step kk the accumulator
    element 4 kk + 2 (f % 2) + f // 2; the tf32 A fragment's register f is
    k-column t % 4 + 4 (f // 2) of the step. With the B operand written at
    k-position ``kpos(c)`` for column c, each thread's fragment pairs every
    accumulator column with its own B row: the product is P V over every
    (lane, register) of the warpgroup."""
    body = WGMMA[WGMMA.index("void acc_to_tf32x3("):]
    assert "d[4 * kk + ((f & 1) << 1) + (f >> 1)]" in body[:body.index("\n}\n")]
    kpos = lambda c: (c & ~7) | ((c & 7) >> 1) | ((c & 1) << 2)
    assert re.search(r"return \(c & ~7\) \| \(\(c & 7\) >> 1\) \| \(\(c & 1\) << 2\);", WGMMA)
    acc_col = lambda t, i: 8 * (i >> 2) + 2 * (t & 3) + (i & 1)
    assert sorted(kpos(c) for c in range(64)) == list(range(64))
    for t in range(128):
        for kk in range(8):
            for f in range(4):
                i = 4 * kk + ((f & 1) << 1) + (f >> 1)
                kcol = 8 * kk + (t & 3) + 4 * (f >> 1)  # the fragment's k-position
                assert kpos(acc_col(t, i)) == kcol
                assert (i >> 1) & 1 == f & 1  # the same row (acc_row's 8 (i / 2 % 2), the fragment's 8 (f % 2))
    # a random P V through the permutation
    rng = np.random.default_rng(5)
    p, v = rng.standard_normal((64, 64)), rng.standard_normal((64, 16))
    vt_stored = np.zeros_like(v)
    vt_stored[[kpos(c) for c in range(64)]] = v
    a = np.zeros_like(p)
    for c in range(64):
        a[:, kpos(c)] = p[:, c]
    np.testing.assert_allclose(a @ vt_stored, p @ v, rtol=1e-12)


def test_route_and_constants_match_the_cuda_sources():
    """float32 calls of both entry points dispatch to the 3xTF32 kernels and
    to no CUDA-core attention kernel (none is left for K4/K5/K10 or K7/K8);
    the backward sums dP to nearest; the three products of every k-step
    lo.hi first and hi.hi last; shared memory within a CTA's limit at every
    head width (the sizes as the sources define them)."""
    launch_f32 = FWD[FWD.index("int launch_f32("):FWD.index("int launch_bf16(")]
    assert "flash_alibi_tf32x3_kernel<DH, OFFSET>" in launch_f32 and "F32Tiles<DH>::SMEM" in launch_f32
    assert "flash_alibi_kernel<" not in FWD
    bwd = TRAIN[TRAIN.index("int train_bwd("):TRAIN.index("bool bad_shape(")]
    f32 = bwd[bwd.index("vap::kF32"):]
    assert "flash_train_dkv_tf32x3_kernel<DH>, flash_train_dq_tf32x3_kernel<DH>" in f32
    assert "BwdTiles<DH>::PANELS" in f32
    assert "flash_train_dkv_kernel<" not in TRAIN and "flash_train_dq_kernel<" not in TRAIN
    # the training forward: float32 on its 3xTF32 kernel, no CUDA-core forward
    # left; the keep mask from the accumulator's own (row, column), before p
    # is split into the permuted fragments
    fwd = TRAIN[TRAIN.index("int train_fwd("):TRAIN.index("template <typename T, typename DKV, typename DQ>")]
    f32_fwd = fwd[fwd.index("vap::kF32"):]
    assert "flash_train_fwd_tf32x3_kernel<DH>" in f32_fwd and "wg::F32Tiles<DH>::SMEM" in f32_fwd
    assert "flash_train_fwd_kernel<" not in TRAIN and "tile_floats" not in TRAIN
    body = TRAIN[TRAIN.index("flash_train_fwd_tf32x3_kernel("):]
    body = body[:body.index("\n}\n")]
    assert body.index("keep(dr, bh, gi0 + 8 * h, k0 + wg::acc_col(tid, i))") < body.index("wg::acc_to_tf32x3(s, ph, pl)")
    assert body.index("l[h] += p;") < body.index("keep(dr, bh")
    assert len(re.findall(r"tile_abt_tf32x3<DH>\(", body)) == 1 and "expf(" in body and "__expf" not in body
    # S to nearest at Dh = 128 only
    assert "NEAREST_S = DH > wg::TILE;" in TRAIN and "tile_abt_tf32x3_nearest<DH>(s, f, Qh, Ql, Kh, Kl);" in body
    assert "using L = wg::F32Tiles<DH>;" in body  # the inference forward's tiles
    # dP summed a k-step at a time to nearest in both backward kernels; S and
    # the outputs' tiles as three products into one accumulator
    for kernel, dp in (("flash_train_dkv_tf32x3_kernel(", "dpT, f, Vh, Vl, Oh, Ol"),
                       ("flash_train_dq_tf32x3_kernel(", "dp, f, Oh, Ol, Vh, Vl")):
        body = TRAIN[TRAIN.index(kernel):]
        body = body[:body.index("\n}\n")]
        assert re.findall(r"tile_abt_tf32x3_nearest<CH>\(([^)]*)\)", body) == [dp]
        assert len(re.findall(r"tile_abt_tf32x3<CH>\(", body)) == 1
    # three products a k-step, A_lo B_hi, A_hi B_lo, A_hi B_hi
    for fn, call in (("tile_abt_tf32x3(", "mma_tf32_ss"), ("tile_rs_tf32x3(", "mma_tf32_rs")):
        body = WGMMA[WGMMA.index(fn):]
        body = body[:body.index("\n}\n")]
        order = re.findall(call + r"\(d, (?:desc_k\()?a_(hi|lo)(?:\[kk\]| \+ p, ks\)), desc_k\(b_(hi|lo)", body)
        assert order == [("lo", "hi"), ("hi", "lo"), ("hi", "hi")], order
    # shared memory as the sources define it (the f32 forwards' tiles in wgmma.cuh)
    assert re.search(r"SMEM = 4 \* OP \+ 4 \* VPANEL \+ 1024;", WGMMA)
    assert re.search(r"DKV_SMEM = 8 \* OP \+ 4 \* TR \+ 2 \* BT \* sizeof\(float\) \+ 1024;", TRAIN)
    assert re.search(r"DQ_SMEM = 8 \* OP \+ 2 \* TR \+ 1024;", TRAIN)
    for dh in k4.HEAD_DIMS:
        op, vpanel = dh * 256, max(dh, 64) * 128
        fwd = 4 * op + 4 * vpanel + 1024
        ch = min(dh, 64)
        dkv, dq = 8 * ch * 256 + 4 * 16384 + 512 + 1024, 8 * ch * 256 + 2 * 16384 + 1024
        assert max(fwd, dkv, dq) <= SMEM_LIMIT, (dh, fwd, dkv, dq)
        # blocks an SM at the forward's size (228 KB a SM, 1 KB each reserved)
        assert (233_472 // (fwd + 1024)) == {32: 3, 64: 2, 128: 1}[dh]


def test_f32_wrappers_check_alignment_on_the_card_only():
    """The f32 kernels read 16-byte pieces, so the wrappers check the
    alignment of f32 CUDA tensors too (``_build.check_aligned``); CPU
    tensors take the plain versions whatever their offset."""
    src = (_build.PKG_DIR / "ops" / "flash_alibi.py").read_text()
    launch = src[src.index("def _launch("):src.index("class _FlashAlibi")]
    assert re.search(r"\n        _build\.check_aligned\(t, ", launch)  # not under a dtype test
    src = (_build.PKG_DIR / "ops" / "flash_alibi_train.py").read_text()
    bwd = src[src.index("def flash_train_backward("):src.index("class _FlashAlibiTrain")]
    assert re.search(r"\n    for name, t in \(\(\"q\", q\), \(\"k\", k\), \(\"v\", v\), \(\"do\", do\)\):", bwd)
    fwd = src[src.index("def flash_train_forward("):src.index("def flash_train_backward(")]
    assert re.search(r"\n    for name, t in \(\(\"q\", q\), \(\"k\", k\), \(\"v\", v\)\):", fwd)
    buf = torch.randn(1 + 4 * 8 * 64)
    odd = buf[1:].view(1, 4, 8, 64)
    got = k4.flash_alibi_attention(odd, odd, odd, alibi_slopes(4), SCALE)
    torch.testing.assert_close(got, k4.dense_reference(odd, odd, odd, alibi_slopes(4), SCALE))


def test_dp_summed_to_nearest_keeps_ds_row_sums():
    """dS = W (dP - delta) sums to zero over each row's keys when
    delta = rowsum(P dP). H=4, T=128, Dh=64, randn: dP summed straight in
    the truncating accumulator lands up to 2.7e-5 from float64 and leaves
    row sums up to 9.5e-6; summed a k-step at a time with nearest adds, 5.6e-6
    and 1.5e-6, under plain f32's 1.1e-5 and 2.5e-6 (three seeds)."""
    slopes = alibi_slopes(H).double()
    T = 128
    i = torch.arange(T)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        q, k, v, do = (_randn(rng, H, T, DH) for _ in range(4))
        s = (q.double() @ k.double().transpose(1, 2)) * SCALE + slopes[:, None, None] * (i[None, :] - i[:, None])
        p = torch.softmax(s.masked_fill(i[None, :] > i[:, None], float("-inf")), -1)
        dp64 = do.double() @ v.double().transpose(1, 2)
        delta = (do.double() * (p @ v.double())).sum(-1, keepdim=True).float()
        got = {}
        for name, dp in (("f32", do @ v.transpose(1, 2)),
                         ("direct", _product(torch.zeros(H, T, T), do, v.transpose(1, 2))),
                         ("nearest", _product_nearest(torch.zeros(H, T, T), do, v.transpose(1, 2)))):
            row_sums = (p.float() * (dp - delta)).double().sum(-1)
            got[name] = (float((dp.double() - dp64).abs().max()), float(row_sums.abs().max()))
        assert got["nearest"][0] <= got["f32"][0] and got["nearest"][1] <= got["f32"][1], got
        assert got["direct"][1] >= 2.5 * got["nearest"][1], got


def _emulated_backward(dp_nearest):
    """``flash_train_backward`` as the f32 kernels compute it at rate 0: per
    (query tile, key tile) S in 3xTF32, dP in 3xTF32 summed a k-step at a
    time to nearest (``dp_nearest``) or straight, W from the forward's lse,
    dS = W (dP - delta), and dQ, dK, dV each tile's products in a fresh
    accumulator added in f32."""

    def backward(q, k, v, slopes, seed, out, lse, do, scale, rate):
        assert rate == 0.0
        B, Hh, T, Dh = q.shape
        Tp = -(-T // TILE) * TILE
        flat = lambda t: _rows(t.reshape(B * Hh, T, Dh).float(), 0, Tp)
        Q, K, V, DO = flat(q), flat(k), flat(v), flat(do)
        lse_p = _rows(lse[..., None], 0, Tp)[..., 0]
        delta = _rows((do.float() * out.float()).sum(-1).reshape(B * Hh, T, 1), 0, Tp)[..., 0]
        slope = slopes.float().repeat(B)[:, None, None]
        dq, dk, dv = (torch.zeros(B * Hh, Tp, Dh) for _ in range(3))
        zeros = lambda n: torch.zeros(B * Hh, TILE, n)
        for k0 in range(0, Tp, TILE):
            ks = slice(k0, k0 + TILE)
            for q0 in range(k0, Tp, TILE):
                qs = slice(q0, q0 + TILE)
                i = torch.arange(q0, q0 + TILE)[None, :, None]
                j = torch.arange(k0, k0 + TILE)[None, None, :]
                s = _product(zeros(TILE), Q[:, qs], K[:, ks].transpose(1, 2))
                sum_dp = _product_nearest if dp_nearest else _product
                dp = sum_dp(zeros(TILE), DO[:, qs], V[:, ks].transpose(1, 2))
                w = torch.where((j <= i) & (i < T), _exp(s * scale + slope * (j - i).float() - lse_p[:, qs, None]),
                                torch.zeros(()))
                ds = w * (dp - delta[:, qs, None])
                dv[:, ks] += _product(zeros(Dh), w.transpose(1, 2), DO[:, qs])
                dk[:, ks] += _product(zeros(Dh), ds.transpose(1, 2), Q[:, qs])
                dq[:, qs] += _product(zeros(Dh), ds, K[:, ks])
        back = lambda t: t[:, :T].reshape(B, Hh, T, Dh)
        return back(scale * dq), back(scale * dk), back(dv)

    return backward


def test_3xtf32_backward_in_a_train_step(monkeypatch):
    """A frozen-encoder float32 step at ``VapConfig()`` widths and dropout 0
    on B=1 x 2 s (T=100, two tiles), the card's card-vs-CPU step: the
    attention takes the kernel route with the emulated f32 backward, held to
    the same step with dense attention under autograd, each gradient
    relative to its leaf's largest. With dP summed to nearest (the kernels)
    every leaf lies within a fifth of the step bar (measured 5.6e-6, the
    cross-attention's key projection, at plain f32's level: 9.3e-6); with dP
    straight in the accumulator the same leaf drifts at least three times as
    far (5.8e-5; the card read 1.07e-4, over the bar)."""
    conf = VapConfig(dropout=0.0)
    state = params_from_jax(random_params_tree(conf, seed=0), conf)
    rng = np.random.default_rng(0)
    batch = {"waveform": torch.from_numpy((0.1 * rng.standard_normal((1, 2, 32_000))).astype(np.float32)),
             "vad": torch.from_numpy((rng.random((1, 200, 2)) < 0.4).astype(np.float32))}
    use_kernels = attn_ops.use_kernels

    def grads(backward=None):
        with monkeypatch.context() as m:
            if backward is not None:  # the kernel route on CPU tensors, the emulated backward
                m.setattr(attn_ops, "use_kernels", lambda *a, **kw: True)
                m.setattr(ft, "flash_train_backward", backward)
            net = VapNet(conf)
            net.load_state_dict(state)
            tstep.make_train_step(conf, tstep.make_optimizer(OptConfig(), net, True))(
                net, batch, torch.Generator().manual_seed(0))
        assert attn_ops.use_kernels is use_kernels
        return {n: p.grad for n, p in net.named_parameters() if p.grad is not None}

    want = grads()
    rel = lambda got: max(float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30) for n, w in want.items())
    nearest, direct = rel(grads(_emulated_backward(True))), rel(grads(_emulated_backward(False)))
    assert nearest <= STEP_BAR / 5, nearest
    assert direct >= 3 * nearest, (direct, nearest)
