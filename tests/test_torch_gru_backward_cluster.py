"""PyTorch port: the GRU backward's (K9) cluster designs at H = 256, in
bfloat16 (``csrc/gru_bwd_cluster.cuh``) and in float32
(``csrc/gru_bwd_cluster_f32.cuh``), route and tiling by
``ops/gru_cluster.py`` ``backward_tiling``, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against the plain version there). Here: the
route and tiling rule of the backward; the rule against the constants and
instantiations of the CUDA source; a torch emulation of the design's
arithmetic (the gate coefficients from one product ahead of the loop, dg
split into two bf16 halves, the 8 CTAs' partial sums of dg W_hh^T added in
rank order, dW_hh and db_hh from the hi and lo passes) held to the port's
plain version and to JAX's ``jax.vjp`` of ``_scan_recurrence`` at the
card's bf16 bar; the float32 design's schedule emulated the same way (the
coefficient pre-pass, the reverse loop with the 8 CTAs' f32 partials added
in rank order, dW_hh and db_hh summed slice by slice in slice order) held
to the plain version and to JAX's Pallas backward in interpret mode at the
card's f32 bar; and the wrapper on CPU tensors taking the plain version
without counting a launch.
"""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.ops.gru_pallas import _scan_recurrence
from voiceactivityprojection_tpu_torch.ops import _build, gru_cluster
from voiceactivityprojection_tpu_torch.ops import gru_recurrence as k3

from _torch_tol import bf16_tol

pytestmark = pytest.mark.encoder

torch.set_num_threads(2)

BF16 = torch.bfloat16
H = 256
# clusters an H100 could hold at once: one CTA an SM, 15 clusters of 8
# SMs (what the card reports for the forward's tilings)
RESIDENT = 15
SOURCE = _build.CSRC_DIR / "gru_bwd_cluster.cuh"
F32_SOURCE = _build.CSRC_DIR / "gru_bwd_cluster_f32.cuh"
# K9's float32 bar on the card (chip_smoke.py F32_REL["gru_backward"]):
# 1e-5 of each output's largest magnitude, at least 1
F32_REL = 1e-5


def _resident(c, n):
    return RESIDENT


# ------------------------------------------------------------- the rule --
def test_backward_tiling_covers_every_row_once():
    """R = 1..300 in bf16 at H = 256: each row in exactly one tile (tile i
    takes rows [i N, i N + N), the last holds row R - 1), clusters of 8
    CTAs, each CTA's shared memory as the rule reckons it within the
    H100's 232,448 bytes, waves counted."""
    for R in range(1, 301):
        t = gru_cluster.backward_tiling(R, H, BF16, _resident)
        assert t.route == "cluster"
        assert (t.tiles - 1) * t.rows < R <= t.tiles * t.rows
        assert t.cluster == 8 and (8, t.rows) in gru_cluster.BACKWARD_TILINGS
        assert t.smem == gru_cluster.backward_smem_bytes(t.rows, t.cluster) <= gru_cluster.MAX_SMEM
        assert t.waves == -(-t.tiles // RESIDENT)


@pytest.mark.parametrize("R", [1, 2, 32, 128])
def test_backward_keeps_f32_and_other_widths_on_the_block_kernel(R):
    """float32 at H = 256 (CPC, the f32 unfrozen step) takes the float32
    cluster design; any H but 256 stays on the block kernel of
    csrc/gru_backward.cu, in either dtype."""
    t = gru_cluster.backward_tiling(R, H, torch.float32, _resident)
    assert t.route == "cluster" and (t.cluster, t.rows) in gru_cluster.F32_BACKWARD_TILINGS
    for dtype, hidden in ((BF16, 128), (BF16, 64), (torch.float32, 128)):
        t = gru_cluster.backward_tiling(R, hidden, dtype, _resident)
        assert t.route == "block" and t.tiles == R


def test_f32_backward_tiling_covers_every_row_once():
    """R = 1..300 in float32 at H = 256: each row in exactly one tile,
    clusters of 8 CTAs, each CTA's shared memory as the rule reckons it
    within the H100's 232,448 bytes, waves counted."""
    for R in range(1, 301):
        t = gru_cluster.backward_tiling(R, H, torch.float32, _resident)
        assert t.route == "cluster"
        assert (t.tiles - 1) * t.rows < R <= t.tiles * t.rows
        assert t.cluster == 8 and (8, t.rows) in gru_cluster.F32_BACKWARD_TILINGS
        assert t.smem == gru_cluster.f32_backward_smem_bytes(t.rows, t.cluster) <= gru_cluster.MAX_SMEM
        assert t.waves == -(-t.tiles // RESIDENT)


def test_f32_backward_tiling_picks_fewest_waves_then_rows():
    """The unfrozen and CPC steps' R = 32: 8 clusters of 4 rows in one wave
    (16 of 2 would need two); phase 3's R = 3: 2 clusters of 2; R = 128: 8
    clusters of 16."""
    t = gru_cluster.backward_tiling(32, H, torch.float32, _resident)
    assert (t.cluster, t.rows, t.tiles, t.waves) == (8, 4, 8, 1)
    t = gru_cluster.backward_tiling(3, H, torch.float32, _resident)
    assert (t.cluster, t.rows, t.tiles, t.waves) == (8, 2, 2, 1)
    t = gru_cluster.backward_tiling(128, H, torch.float32, _resident)
    assert (t.cluster, t.rows, t.tiles, t.waves) == (8, 16, 8, 1)
    with pytest.raises(RuntimeError, match="no tiling"):
        gru_cluster.backward_tiling(8, H, torch.float32, lambda c, n: 0)


def test_backward_tiling_picks_fewest_waves_then_rows():
    """The unfrozen step's R = 32: 4 clusters of 8 rows in one wave; R =
    128 (16 clusters of 8 would need two waves) takes 16 rows a cluster."""
    t = gru_cluster.backward_tiling(32, H, BF16, _resident)
    assert (t.cluster, t.rows, t.tiles, t.waves) == (8, 8, 4, 1)
    t = gru_cluster.backward_tiling(128, H, BF16, _resident)
    assert (t.cluster, t.rows, t.tiles, t.waves) == (8, 16, 8, 1)
    with pytest.raises(RuntimeError, match="no tiling"):
        gru_cluster.backward_tiling(8, H, BF16, lambda c, n: 0)


def test_backward_rule_matches_the_cuda_source():
    """The rule's constants, tilings and shared-memory reckoning are the
    kernel's: the header's STAGES and NCOEF, the rows of its dispatch, its
    smem_bytes expression evaluated at each tiling, and the weight
    product's block tiles as the wrapper's splits count them."""
    src = SOURCE.read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("STAGES") == gru_cluster.BACKWARD_STAGES
    assert const("NCOEF") == gru_cluster.N_COEF
    assert const("NT") == 256
    body = src[src.index("inline int dispatch("):src.index("#undef VAP_GB_CASE")]
    rows = [int(n) for n in re.findall(r"VAP_GB_CASE\((\d+)\);", body)]
    assert {(8, n) for n in rows} == set(gru_cluster.BACKWARD_TILINGS)
    expr = re.search(r"constexpr int smem_bytes\(int N\) \{\s*return (.*?);\s*\}", src, re.S).group(1)
    for c, n in gru_cluster.BACKWARD_TILINGS:
        env = {"C": c, "U": 256 // c, "NCOEF": const("NCOEF"), "STAGES": const("STAGES"), "N": n}
        assert eval(expr, {}, env) == gru_cluster.backward_smem_bytes(n, c) <= gru_cluster.MAX_SMEM
    assert re.search(r"DW_ROW_TILES = H / 64 \+ 1;", src) and re.search(r"DW_COL_TILES = G / 256;", src)
    assert k3._DW_TILES == (256 // 64 + 1) * (768 // 256)


def test_backward_smem_reckoning_is_the_sum_of_its_regions():
    """backward_smem_bytes at 8 rows, written out region by region."""
    b_tiles = 2 * 2 * (2 * 8 * 128)        # two B tiles of two panels, hi and lo rows
    slices = 3 * 8 * 8 * 32 * 4            # two receive buffers and the staging
    ring = 4 * 8 * (5 * 32 * 4 + 32 * 2)   # coefficients and dys, four stages
    assert gru_cluster.backward_smem_bytes(8, 8) == 1024 + b_tiles + slices + ring + 16 == 56_336
    assert gru_cluster.backward_smem_bytes(32, 8) == 222_224


def test_f32_backward_rule_matches_the_cuda_source():
    """The float32 rule's constants, tilings and shared-memory reckoning
    are the kernel's: the header's STAGES, NCOEF and NT, the rows of its
    dispatch, its smem_bytes expression evaluated at each tiling, and the
    weight product's tiles and chunk as the wrapper's splits count them."""
    src = F32_SOURCE.read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("STAGES") == gru_cluster.BACKWARD_STAGES
    assert const("NCOEF") == gru_cluster.N_COEF
    assert const("NT") == gru_cluster.F32_BACKWARD_THREADS == 256
    body = src[src.index("inline int dispatch("):src.index("#undef VAP_GBF_CASE")]
    rows = [int(n) for n in re.findall(r"VAP_GBF_CASE\((\d+)\);", body)]
    assert {(8, n) for n in rows} == set(gru_cluster.F32_BACKWARD_TILINGS)
    expr = re.search(r"constexpr int smem_bytes\(int N\) \{\s*return (.*?);\s*\}", src, re.S).group(1)
    for c, n in gru_cluster.F32_BACKWARD_TILINGS:
        env = {"C": c, "U": 256 // c, "NCOEF": const("NCOEF"), "STAGES": const("STAGES"), "NT": const("NT"),
               "KOWN": 3 * (256 // c), "N": n}
        assert eval(expr, {}, env) == gru_cluster.f32_backward_smem_bytes(n, c) <= gru_cluster.MAX_SMEM
    assert re.search(r"DW_COL_TILES = G / TN;", src) and re.search(r"DW_ROW_TILES = H / TM;", src)
    assert const("TM") == 64 and const("TN") == 192 and const("KC") == k3._F32_DW_CHUNK
    assert k3._F32_DW_TILES == (256 // 64) * (768 // 192)


def test_f32_backward_smem_reckoning_is_the_sum_of_its_regions():
    """f32_backward_smem_bytes at 4 rows, written out region by region; 32
    rows, the largest tiling, within a CTA's shared memory."""
    recv = 2 * 8 * 4 * 32 * 4              # two receive buffers [rank][row][unit]
    staging = 8 * 4 * 32 * 4               # eight warps' send staging
    dg = 2 * 4 * 96 * 4                    # two dg buffers [row][96]
    ring = 4 * 4 * (5 + 1) * 32 * 4        # coefficients and dys, four stages
    assert gru_cluster.f32_backward_smem_bytes(4, 8) == recv + staging + dg + ring + 16 == 27_664
    assert gru_cluster.f32_backward_smem_bytes(32, 8) == 221_200 <= gru_cluster.MAX_SMEM


@pytest.mark.parametrize("rows,want", [(64000, 17), (4096, 17), (99, 7), (1, 1)])
def test_f32_cluster_weight_splits(rows, want):
    """The float32 weight product cuts its R*T rows into slices: enough
    (tile, slice) blocks for two an SM of an H100 (16 tiles), one 16-row
    chunk at least."""
    assert k3.f32_cluster_weight_splits(rows) == want


@pytest.mark.parametrize("rows,want", [(64000, 18), (4096, 18), (99, 4), (1, 1)])
def test_cluster_weight_splits(rows, want):
    """The weight product cuts its 2 R*T rows into slices: enough (tile,
    slice) blocks for two an SM of an H100 (15 tiles), one 64-row chunk
    at least."""
    assert k3.cluster_weight_splits(rows) == want


# ------------------------------------------------ the design's arithmetic --
def _emulate(x_proj, w_hh, b_hh, h0, ys, dys, dh_last):
    """The cluster design's arithmetic in torch, for bf16 inputs:

    1. the coefficients (a_r, a_z, a_n, r, z) from hp = h_{t-1} @ W_hh +
       b_hh, one product over every row and step (bf16 products, f32
       sums), gates in f32;
    2. the reverse loop: dh_t = G_{t+1} z_{t+1} + the 8 CTAs' partials in
       rank order, CTA k's partial being dg[:, own_k] @ W_hh[:, own_k]^T
       with dg split into hi = bf16(dg) and lo = bf16(dg - hi), each
       multiplied by the bf16 W_hh and summed in f32;
    3. dW_hh = h_{t-1}^T hi + h_{t-1}^T lo, db_hh = sum hi + sum lo.
    Outputs cast as the wrapper casts them."""
    R, T, G = x_proj.shape
    dys = k3._fold_dh_last(dys, dh_last).float()
    w, b, xp = w_hh.float(), b_hh.float(), x_proj.float()
    hprev = torch.cat([h0[:, None], ys[:, :-1]], dim=1).float()
    hp = hprev @ w + b
    r = torch.sigmoid(xp[..., :H] + hp[..., :H])
    z = torch.sigmoid(xp[..., H:2 * H] + hp[..., H:2 * H])
    hn = hp[..., 2 * H:]
    n = torch.tanh(xp[..., 2 * H:] + r * hn)
    a_n = (1.0 - z) * (1.0 - n * n)
    a_z = (hprev - n) * z * (1.0 - z)
    a_r = a_n * hn * r * (1.0 - r)
    # CTA k's 96 gate columns and the W_hh columns it keeps resident
    own = [torch.tensor([g * H + 32 * k + u for g in range(3) for u in range(32)]) for k in range(8)]
    w_own = torch.stack([w[:, cols] for cols in own])  # (8, H, 96)

    def partials(hi, lo):
        # (8, R, H): each CTA's hi and lo products, added per thread
        p_hi = torch.einsum("kri,khi->krh", torch.stack([hi[:, c] for c in own]), w_own)
        p_lo = torch.einsum("kri,khi->krh", torch.stack([lo[:, c] for c in own]), w_own)
        return p_hi + p_lo

    def ranked(p):
        s = torch.zeros_like(p[0])
        for k in range(8):
            s = s + p[k]
        return s

    gz = torch.zeros(R, H)
    part = None
    dxp = torch.empty(R, T, G)
    hi_all = torch.empty(R, T, G, dtype=BF16)
    lo_all = torch.empty(R, T, G, dtype=BF16)
    for t in range(T - 1, -1, -1):
        dh = gz if part is None else gz + ranked(part)
        g = dh + dys[:, t]
        d = torch.cat([g * a_r[:, t], g * a_z[:, t], g * a_n[:, t] * r[:, t]], dim=-1)
        dxp[:, t] = torch.cat([g * a_r[:, t], g * a_z[:, t], g * a_n[:, t]], dim=-1)
        gz = g * z[:, t]
        hi = d.to(BF16)
        lo = (d - hi.float()).to(BF16)
        hi_all[:, t], lo_all[:, t] = hi, lo
        part = partials(hi.float(), lo.float())
    dh0 = gz + ranked(part)
    hp2 = hprev.reshape(R * T, H).T
    dw = hp2 @ hi_all.reshape(R * T, G).float() + hp2 @ lo_all.reshape(R * T, G).float()
    db = hi_all.float().sum(dim=(0, 1)) + lo_all.float().sum(dim=(0, 1))
    return dxp.to(BF16), dw.to(BF16), db.to(BF16), dh0.to(BF16)


def _inputs(R, T, seed):
    """bf16 inputs at the encoder's scale: x_proj, W_hh, b_hh, a nonzero h0,
    dys and a dh_last, from numpy."""
    rng = np.random.default_rng(seed)
    arrs = [0.5 * rng.standard_normal((R, T, 3 * H)), rng.standard_normal((H, 3 * H)) / 16,
            0.1 * rng.standard_normal(3 * H), 0.1 * rng.standard_normal((R, H)),
            rng.standard_normal((R, T, H)), rng.standard_normal((R, H))]
    return [torch.from_numpy(a.astype(np.float32)).to(BF16) for a in arrs]


def _jax_grads(x_proj, w_hh, b_hh, h0, dys, dh_last):
    """``jax.vjp`` of the JAX package's scan recurrence (the oracle of
    tests/test_torch_gru_backward.py) on the same bf16 values in f32."""
    f = lambda *a: jnp.asarray(a[0].float().numpy())
    args = [f(a) for a in (x_proj, w_hh, b_hh, h0)]
    _, vjp = jax.vjp(_scan_recurrence, *args)
    return [torch.from_numpy(np.array(g)) for g in vjp((f(dys), f(dh_last)))]


@pytest.mark.parametrize("R,T", [(32, 2000), (9, 33)])
def test_cluster_arithmetic_matches_plain_and_jax(R, T):
    """The emulation at the unfrozen step's shape (R=32 x 2000) and at a
    ragged one, with a nonzero h0 and a dh_last, within the card's bar for
    K9 in bf16 (``chip_smoke.py`` BF16_STEPS: two bf16 roundings at each
    output's largest magnitude) of the port's plain version on the same
    bf16 inputs, and of JAX's gradients of the scan recurrence."""
    x_proj, w_hh, b_hh, h0, dys, dh_last = _inputs(R, T, seed=R * 1000 + T)
    ys, _ = k3.gru_recurrence_reference(x_proj, w_hh, b_hh, h0)
    got = _emulate(x_proj, w_hh, b_hh, h0, ys, dys, dh_last)
    want = k3.gru_backward_reference(x_proj, w_hh, b_hh, h0, ys, dys, dh_last)
    jax_want = _jax_grads(x_proj, w_hh, b_hh, h0, dys, dh_last)
    for name, g, w, j in zip(("dx_proj", "dw_hh", "db_hh", "dh0"), got, want, jax_want):
        assert g.dtype == w.dtype == BF16 and g.shape == w.shape == j.shape, name
        torch.testing.assert_close(g.float(), w.float(), atol=bf16_tol(w.float()), rtol=0, msg=name)
        torch.testing.assert_close(g.float(), j, atol=bf16_tol(j), rtol=0, msg=name)


def _emulate_f32(x_proj, w_hh, b_hh, h0, ys, dys, dh_last):
    """The float32 cluster design's schedule in torch, all in f32:

    1. the coefficients (a_r, a_z, a_n, r, z) from hp = h_{t-1} @ W_hh +
       b_hh, one product over every row and step ahead of the loop;
    2. the reverse loop: dh_t = G_{t+1} z_{t+1} + the 8 CTAs' partials
       added in rank order, CTA k's partial being dg[:, own_k] @
       W_hh[:, own_k]^T (its 96 gate columns, f32);
    3. dW_hh and db_hh over the R T rows cut into the wrapper's slices
       (16-row chunks), each slice's h_{t-1}^T dgates and column sums, the
       slices added in slice order."""
    R, T, G = x_proj.shape
    dys = k3._fold_dh_last(dys, dh_last)
    w = w_hh
    hprev = torch.cat([h0[:, None], ys[:, :-1]], dim=1)
    hp = hprev @ w + b_hh
    r = torch.sigmoid(x_proj[..., :H] + hp[..., :H])
    z = torch.sigmoid(x_proj[..., H:2 * H] + hp[..., H:2 * H])
    hn = hp[..., 2 * H:]
    n = torch.tanh(x_proj[..., 2 * H:] + r * hn)
    a_n = (1.0 - z) * (1.0 - n * n)
    a_z = (hprev - n) * z * (1.0 - z)
    a_r = a_n * hn * r * (1.0 - r)
    own = [torch.tensor([g * H + 32 * k + u for g in range(3) for u in range(32)]) for k in range(8)]
    w_own = torch.stack([w[:, cols] for cols in own])  # (8, H, 96)

    def ranked(p):
        s = torch.zeros_like(p[0])
        for k in range(8):
            s = s + p[k]
        return s

    gz = torch.zeros(R, H)
    part = None
    dxp = torch.empty(R, T, G)
    dgates = torch.empty(R, T, G)
    for t in range(T - 1, -1, -1):
        dh = gz if part is None else gz + ranked(part)
        g = dh + dys[:, t]
        dr, dz, dn = g * a_r[:, t], g * a_z[:, t], g * a_n[:, t]
        dxp[:, t] = torch.cat([dr, dz, dn], dim=-1)
        dg = torch.cat([dr, dz, dn * r[:, t]], dim=-1)
        dgates[:, t] = dg
        gz = g * z[:, t]
        part = torch.einsum("kri,khi->krh", torch.stack([dg[:, c] for c in own]), w_own)
    dh0 = gz + ranked(part)
    M = R * T
    splits = k3.f32_cluster_weight_splits(M)
    per = -(-(-(-M // splits)) // 16) * 16
    h2, d2 = hprev.reshape(M, H), dgates.reshape(M, G)
    dw, db = torch.zeros(H, G), torch.zeros(G)
    for s in range(splits):
        sl = slice(s * per, min((s + 1) * per, M))
        dw = dw + h2[sl].T @ d2[sl]
        db = db + d2[sl].sum(dim=0)
    return dxp, dw, db, dh0


def _inputs_f32(R, T, seed):
    """float32 inputs at the encoder's scale (as ``_inputs``, unrounded)."""
    rng = np.random.default_rng(seed)
    arrs = [0.5 * rng.standard_normal((R, T, 3 * H)), rng.standard_normal((H, 3 * H)) / 16,
            0.1 * rng.standard_normal(3 * H), 0.1 * rng.standard_normal((R, H)),
            rng.standard_normal((R, T, H)), rng.standard_normal((R, H))]
    return [torch.from_numpy(a.astype(np.float32)) for a in arrs]


@pytest.mark.parametrize("R,T", [(32, 2000), (9, 33)])
def test_f32_cluster_arithmetic_matches_plain_and_jax(R, T):
    """The float32 emulation at the unfrozen and CPC steps' R = 32 x 2000
    and at a ragged (9, 33), with a nonzero h0 and a dh_last, within K9's
    float32 bar on the card (1e-5 of each output's largest magnitude) of
    the port's plain version on the same inputs and of JAX's Pallas
    backward ``_backward_pallas`` in interpret mode (given the same ys)."""
    from voiceactivityprojection_tpu.ops.gru_pallas import _backward_pallas

    x_proj, w_hh, b_hh, h0, dys, dh_last = _inputs_f32(R, T, seed=R * 1000 + T + 1)
    ys, _ = k3.gru_recurrence_reference(x_proj, w_hh, b_hh, h0)
    got = _emulate_f32(x_proj, w_hh, b_hh, h0, ys, dys, dh_last)
    want = k3.gru_backward_reference(x_proj, w_hh, b_hh, h0, ys, dys, dh_last)
    j = lambda a: jnp.asarray(a.numpy())
    jax_want = [torch.from_numpy(np.array(g)) for g in _backward_pallas(
        j(x_proj), j(w_hh), j(b_hh), j(h0), j(ys), j(dys), j(dh_last))]
    for name, g, w, jw in zip(("dx_proj", "dw_hh", "db_hh", "dh0"), got, want, jax_want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape == jw.shape, name
        tol = F32_REL * max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g, w, atol=tol, rtol=0, msg=name)
        torch.testing.assert_close(g, jw.float(), atol=tol, rtol=0, msg=name)


def test_hi_lo_split_keeps_dg_to_2_pow_16():
    """dg = hi + lo to about 2^-16 of |dg| (the product's precision of the
    f32 dgates that JAX multiplies by W_hh in f32)."""
    d = torch.from_numpy(np.random.default_rng(7).standard_normal(100_000).astype(np.float32))
    hi = d.to(BF16)
    lo = (d - hi.float()).to(BF16)
    assert float(((hi.float() + lo.float()) - d).abs().div(d.abs()).max()) <= 2.0 ** -16


# ------------------------------------------------------------ the wrapper --
def test_cpu_tensors_take_the_plain_backward_without_a_launch():
    """bf16 at H = 256, the cluster design's route on the card: on CPU
    tensors ``gru_backward`` returns the plain version and counts nothing."""
    x_proj, w_hh, b_hh, h0, dys, dh_last = _inputs(3, 9, seed=3)
    ys, _ = k3.gru_recurrence_reference(x_proj, w_hh, b_hh, h0)
    before = _build.launch_counts()
    got = k3.gru_backward(x_proj, w_hh, b_hh, h0, ys, dys, dh_last)
    want = k3.gru_backward_reference(x_proj, w_hh, b_hh, h0, ys, dys, dh_last)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert _build.launch_totals(_build.launches_since(before))["gru_backward"] == 0


def test_cpu_tensors_take_the_plain_f32_backward_without_a_launch():
    """float32 at H = 256, the float32 cluster design's route on the card:
    on CPU tensors ``gru_backward`` returns the plain version and counts
    nothing, by design or in all."""
    x_proj, w_hh, b_hh, h0, dys, dh_last = _inputs_f32(3, 9, seed=4)
    ys, _ = k3.gru_recurrence_reference(x_proj, w_hh, b_hh, h0)
    before = _build.launch_counts()
    got = k3.gru_backward(x_proj, w_hh, b_hh, h0, ys, dys, dh_last)
    want = k3.gru_backward_reference(x_proj, w_hh, b_hh, h0, ys, dys, dh_last)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert _build.launch_counts()["gru_backward"] == before["gru_backward"]
