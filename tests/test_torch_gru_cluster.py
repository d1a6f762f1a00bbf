"""PyTorch port: the GRU cluster kernels' route, tiling and arithmetic
(``ops/gru_cluster.py``, ``csrc/gru_cluster.cuh``,
``csrc/gru_cluster_f32.cuh``), on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py`` holds them
against the plain versions there). Here: the tiling rule that the wrappers
of K2 and K3 apply, in bfloat16 and in float32; that rule against the
constants and instantiations of the CUDA sources; a torch emulation of the
bf16 kernel's arithmetic (the carry split into two bf16 halves, each
multiplied by the bf16 W_hh with an f32 sum, f32 gates) held to the port's
plain version and to JAX's ``gru_recurrence_pallas`` at the bar the card
uses; an emulation of the float32 kernel's schedule (the product summed
over k-slices, the conv's open outputs and their rotation, the LayerNorm
statistics' pipeline over the steps) held to the plain version and to
JAX's GRU and downsample; and the wrappers on CPU tensors taking the plain
versions without counting a launch.
"""

import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.models.encoder import _downsample
from voiceactivityprojection_tpu.ops.gru import gru as jgru
from voiceactivityprojection_tpu.ops.gru_pallas import gru_recurrence_pallas
from voiceactivityprojection_tpu_torch.ops import _build, gru_cluster
from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
from voiceactivityprojection_tpu_torch.ops import gru_recurrence as k3

from _torch_tol import bf16_tol

pytestmark = pytest.mark.encoder

torch.set_num_threads(2)

BF16 = torch.bfloat16
# clusters an H100 holds at once (cudaOccupancyMaxActiveClusters, measured
# on the card for every tiling: one CTA an SM, 15 clusters of 8 SMs)
RESIDENT = {(False, 8, 8): 15, (False, 8, 16): 15, (False, 8, 32): 15, (True, 8, 8): 15,
            (True, 8, 16): 15}
# the float32 K2 kernel's tilings (one CTA an SM, as in bf16)
F32_RESIDENT = {(8, 2): 15, (8, 4): 15, (8, 8): 15, (8, 9): 15}
# the float32 K3 kernel's tilings: 15 clusters, as the other cluster
# kernels (the card's count is checked against it in phase 11 of chip_smoke)
F32_REC_RESIDENT = {(8, 2): 15, (8, 4): 15, (8, 8): 15, (8, 16): 15, (8, 32): 15}
F32 = torch.float32


def _resident(fused, dtype=BF16):
    if dtype == F32:
        return lambda c, n: (F32_RESIDENT if fused else F32_REC_RESIDENT)[(c, n)]
    return lambda c, n: RESIDENT[(fused, c, n)]


# ------------------------------------------------------------- the rule --
@pytest.mark.parametrize("fused", [False, True])
def test_tiling_covers_every_row_once(fused):
    """R = 1..300 at H = 256 in bf16: the tiles cover the rows, each row in
    exactly one (tile i takes rows [i N, i N + N) and the last tile holds
    row R - 1), clusters of at most 8 CTAs, each CTA's shared memory as the
    rule reckons it within the H100's 232,448 bytes, waves counted."""
    for R in range(1, 301):
        t = gru_cluster.tiling(R, 256, BF16, fused, _resident(fused))
        assert t.route == "cluster"
        assert (t.tiles - 1) * t.rows < R <= t.tiles * t.rows
        assert t.cluster == 8 and t.rows % 8 == 0
        assert t.smem == gru_cluster.smem_bytes(t.rows, t.cluster, fused) <= gru_cluster.MAX_SMEM
        assert t.waves == -(-t.tiles // RESIDENT[(fused, t.cluster, t.rows)])


@pytest.mark.parametrize("fused", [False, True])
def test_tiling_keeps_f32_and_other_widths_on_the_block_kernel(fused):
    """Other widths take the block kernels in either dtype; float32 at
    H = 256 takes the f32 cluster kernels (``csrc/gru_cluster_f32.cuh``):
    K2's tilings fused, K3's (2 to 32 rows) not. Both took the block
    kernel before they were ported."""
    for R in (1, 2, 32, 128):
        for dtype, H in ((torch.float32, 256), (BF16, 128), (BF16, 64), (torch.float32, 128)):
            t = gru_cluster.tiling(R, H, dtype, fused, _resident(fused, dtype))
            if dtype == F32 and H == 256:
                tilings = gru_cluster.F32_DOWNSAMPLE_TILINGS if fused else gru_cluster.F32_RECURRENCE_TILINGS
                assert t.route == "cluster" and (t.cluster, t.rows) in tilings
            else:
                assert t.route == "block" and t.tiles == R


def test_f32_tiling_covers_every_row_once():
    """R = 1..300 in float32 at H = 256 (K2): the tiles cover the rows, each
    row in exactly one, clusters of 8 CTAs of 2, 4, 8 or 9 rows, each CTA's
    shared memory as the rule reckons it within the H100's 232,448 bytes,
    waves counted."""
    for R in range(1, 301):
        t = gru_cluster.tiling(R, 256, F32, True, _resident(True, F32))
        assert t.route == "cluster" and t.cluster == 8 and t.rows in (2, 4, 8, 9)
        assert (t.tiles - 1) * t.rows < R <= t.tiles * t.rows
        assert t.smem == gru_cluster.f32_smem_bytes(t.rows, t.cluster) <= gru_cluster.MAX_SMEM
        assert t.waves == -(-t.tiles // F32_RESIDENT[(t.cluster, t.rows)])


def test_f32_tiling_follows_the_rule():
    """The fewest waves, then the fewest rows: the inference batch (R =
    128) in 15 clusters of 9 rows, one wave, where 8 rows would need two;
    the run CLI's stereo file (R = 2) and the probe's batch (R = 20) at 2
    rows a cluster; the evaluation batch (R = 32) at 4; R = 256 in two waves
    of 9-row clusters (8 rows would need three)."""
    want = {128: (9, 15, 1), 2: (2, 1, 1), 20: (2, 10, 1), 32: (4, 8, 1), 64: (8, 8, 1), 256: (9, 29, 2)}
    for R, (rows, tiles, waves) in want.items():
        t = gru_cluster.tiling(R, 256, F32, True, _resident(True, F32))
        assert (t.rows, t.tiles, t.waves) == (rows, tiles, waves), (R, t)


def test_f32_smem_reckoning_is_the_sum_of_its_regions():
    """f32_smem_bytes at 9 rows, region by region; 16 rows (bf16's tiling
    at R = 128) would not fit a CTA, 11 would."""
    n = 9
    w_d = 5 * 256 * 32 * 4
    h_buffers = 3 * n * 256 * 4
    x_ring = 3 * n * 3 * 32 * 4
    slice_pairs = 4 * 3 * n * 32 * 4
    outputs = 2 * n * 32 * 4
    stats = 2 * 2 * 8 * n * 4 + 2 * n * 4
    mbarriers = 3 * 8
    assert gru_cluster.f32_smem_bytes(n, 8) == w_d + h_buffers + x_ring + slice_pairs + outputs + stats + mbarriers
    assert gru_cluster.f32_smem_bytes(n, 8) == 219_232
    assert gru_cluster.f32_smem_bytes(11, 8) <= gru_cluster.MAX_SMEM < gru_cluster.f32_smem_bytes(16, 8)
    # the conv's eight slices of partial sums share the slice pairs' region
    assert 8 * n * 32 * 4 <= slice_pairs


def test_f32_recurrence_tiling_covers_every_row_once():
    """R = 1..600 in float32 at H = 256 (K3): the tiles cover the rows, each
    row in exactly one, clusters of 8 CTAs of 2, 4, 8, 16 or 32 rows, each
    CTA's shared memory as the rule reckons it within the H100's 232,448
    bytes, waves counted."""
    for R in range(1, 601):
        t = gru_cluster.tiling(R, 256, F32, False, _resident(False, F32))
        assert t.route == "cluster" and t.cluster == 8 and t.rows in (2, 4, 8, 16, 32)
        assert (t.tiles - 1) * t.rows < R <= t.tiles * t.rows
        assert t.smem == gru_cluster.f32_recurrence_smem_bytes(t.rows, t.cluster) <= gru_cluster.MAX_SMEM
        assert t.waves == -(-t.tiles // F32_REC_RESIDENT[(t.cluster, t.rows)])


def test_f32_recurrence_tiling_follows_the_rule():
    """The fewest waves, then the fewest rows: the streamers' R = 2 and the
    600 s call's shards (R = 2) at 2 rows a cluster; the frozen and the CPC
    step's R = 32 at 4 (2 rows would need 16 clusters, two waves); the
    batched streamer's R = 128 at 16; R = 512 in two waves of 32-row
    clusters (16 rows would need three)."""
    want = {1: (2, 1, 1), 2: (2, 1, 1), 30: (2, 15, 1), 32: (4, 8, 1), 64: (8, 8, 1), 128: (16, 8, 1),
            256: (32, 8, 1), 512: (32, 16, 2)}
    for R, (rows, tiles, waves) in want.items():
        t = gru_cluster.tiling(R, 256, F32, False, _resident(False, F32))
        assert (t.rows, t.tiles, t.waves) == (rows, tiles, waves), (R, t)


def test_f32_recurrence_smem_reckoning_matches_the_cuda_source():
    """K3's f32 shared memory, region by region at 32 rows (about 4.7 KB a
    row: no W_d, two h buffers), and the rule's tilings, constants and
    reckoning against ``gcf::recurrence_smem_bytes`` and
    ``dispatch_recurrence`` of the CUDA source."""
    n = 32
    h_buffers = 2 * n * 256 * 4
    x_ring = 3 * n * 3 * 32 * 4
    slice_pairs = 4 * 3 * n * 32 * 4
    mbarriers = 2 * 8
    assert gru_cluster.f32_recurrence_smem_bytes(n, 8) == h_buffers + x_ring + slice_pairs + mbarriers == 151_568
    src = (_build.CSRC_DIR / "gru_cluster_f32.cuh").read_text()
    assert int(re.search(r"constexpr int RBUFS = (\d+);", src).group(1)) == gru_cluster.F32_RECURRENCE_H_BUFFERS
    body = src[src.index("inline int dispatch_recurrence("):]
    body = body[:body.index("#undef")]
    rows = [int(m) for m in re.findall(r"VAP_GCF_REC_CASE\((\d+)\);", body)]
    assert {(8, m) for m in rows} == set(gru_cluster.F32_RECURRENCE_TILINGS)
    assert "gru_f32_cluster_kernel<NN>, recurrence_smem_bytes(NN)" in body
    formula = re.search(r"constexpr int recurrence_smem_bytes\(int N\) \{\s*return (.*?);", src, re.S).group(1)
    names = dict(H=256, U=32, RBUFS=2, STAGES=3, KSL=8)
    for c, m in gru_cluster.F32_RECURRENCE_TILINGS:
        assert eval(f"({formula})", {}, dict(names, N=m)) == gru_cluster.f32_recurrence_smem_bytes(m, c)
    # the wrapper's query names map to these reckonings
    assert gru_cluster.SMEM_OF["vap_gru_recurrence_cluster_f32_info"] is gru_cluster.f32_recurrence_smem_bytes
    assert gru_cluster.SMEM_OF["vap_gru_downsample_cluster_f32_info"] is gru_cluster.f32_smem_bytes
    assert k3.CLUSTER_ENTRIES[F32] == ("vap_gru_recurrence_cluster_f32", "vap_gru_recurrence_cluster_f32_info")
    lib_src = (_build.CSRC_DIR / "gru_recurrence.cu").read_text()
    for entry in k3.CLUSTER_ENTRIES[F32]:
        assert f'extern "C" int {entry}(' in lib_src


def test_f32_step_is_shared_by_k2_and_k3():
    """Both float32 kernels run the one step of the source: the product,
    the gate math and the send each appear once as a function, called by
    both kernels."""
    src = (_build.CSRC_DIR / "gru_cluster_f32.cuh").read_text()
    k3_body = src[src.index("gru_f32_cluster_kernel(const RecParams p)"):src.index("// ---- K2:")]
    k2_body = src[src.index("gru_ds_f32_cluster_kernel(const Params p)"):src.index("// ---- host side")]
    for call in ("step_product<N>(cur, wr, red, gs, gu, w, lane);", "gate_math<N>(red, xs + (t % STAGES) * XSTAGE",
                 "send_slice<N>(nxt, rank, next_bar, tid);", "load_w_hh(wr, p.w_hh, rank, gs, gu);"):
        assert call in k3_body and call in k2_body, call
    assert "p.ys[" in k3_body and "p.ys" not in k2_body


def test_tiling_prefers_one_wave():
    """At the inference batch (R = 128) 16 clusters of 8 rows would need
    two waves (15 resident): K2 and K3 take 16 rows a cluster."""
    for fused in (True, False):
        t = gru_cluster.tiling(128, 256, BF16, fused, _resident(fused))
        assert (t.cluster, t.rows, t.tiles, t.waves) == (8, 16, 8, 1)
    # the 600 s call's shards (R = 2) and the train step (R = 32)
    for R in (2, 32):
        t = gru_cluster.tiling(R, 256, BF16, False, _resident(False))
        assert t.waves == 1 and t.rows == 8


def test_tiling_raises_when_nothing_fits():
    with pytest.raises(RuntimeError, match="no tiling"):
        gru_cluster.tiling(8, 256, BF16, False, lambda c, n: 0)


def test_rule_matches_the_cuda_source():
    """The rule's constants and tilings are the kernel's: the cluster size,
    STAGES, TILE_BYTES, NOUT_SLOTS and the K halves as the header defines
    them, and the rows of its dispatch, per route."""
    src = (_build.CSRC_DIR / "gru_cluster.cuh").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    for name, value in (("STAGES", gru_cluster.STAGES), ("NOUT_SLOTS", gru_cluster.NOUT_SLOTS),
                        ("KS", gru_cluster.K_HALVES), ("C", 8)):
        assert const(name) == value
    assert re.search(r"constexpr int TILE_BYTES = 256 \* 128;", src)
    body = src[src.index("int dispatch("):src.index("#undef")]
    rows = [int(n) for n in re.findall(r"VAP_GC_CASE\((\d+)\);", body)]
    recurrence_only = [int(n) for n in re.findall(r"if constexpr \(!DS\) VAP_GC_CASE\((\d+)\);", body)]
    assert {(8, n) for n in rows} == set(gru_cluster.RECURRENCE_TILINGS)
    assert {(8, n) for n in rows if n not in recurrence_only} == set(gru_cluster.DOWNSAMPLE_TILINGS)
    for fused, tilings in ((False, gru_cluster.RECURRENCE_TILINGS), (True, gru_cluster.DOWNSAMPLE_TILINGS)):
        for c, n in tilings:
            assert gru_cluster.smem_bytes(n, c, fused) <= gru_cluster.MAX_SMEM
    # the float32 kernel: its constants, its dispatch's rows, and its shared
    # memory formula evaluated on the rule's constants
    src = (_build.CSRC_DIR / "gru_cluster_f32.cuh").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    for name, value in (("C", 8), ("STAGES", gru_cluster.STAGES), ("KSL", gru_cluster.F32_K_SLICES),
                        ("HBUFS", gru_cluster.F32_H_BUFFERS), ("TAPS", gru_cluster.F32_TAPS), ("H", 256)):
        assert const(name) == value
    body = src[src.index("inline int dispatch("):src.index("#undef")]
    rows = [int(n) for n in re.findall(r"VAP_GCF_CASE\((\d+)\);", body)]
    assert {(8, n) for n in rows} == set(gru_cluster.F32_DOWNSAMPLE_TILINGS)
    formula = re.search(r"constexpr int smem_bytes\(int N\) \{\s*return (.*?);", src, re.S).group(1)
    names = dict(TAPS=5, H=256, U=32, HBUFS=3, STAGES=3, KSL=8, C=8)
    for c, n in gru_cluster.F32_DOWNSAMPLE_TILINGS:
        assert eval(f"({formula})", {}, dict(names, N=n)) == gru_cluster.f32_smem_bytes(n, c) <= gru_cluster.MAX_SMEM


# ------------------------------------------------ the kernel's arithmetic --
def _emulate(x_proj, w_hh, b_hh, h0):
    """The cluster kernel's arithmetic in torch: each step's product is
    W_hh (bf16) times h_hi = bf16(h) plus W_hh times h_lo = bf16(h - h_hi),
    summed in f32; the gates in f32 with b_hh added to the product, as the
    kernel adds it to the accumulator; ys = bf16(h) = h_hi."""
    w, b = w_hh.float(), b_hh.float()
    h = h0.float()
    H = h.shape[1]
    ys = []
    for t in range(x_proj.shape[1]):
        hi = h.to(BF16).float()
        lo = (h - hi).to(BF16).float()
        acc = hi @ w + lo @ w
        x = x_proj[:, t].float()
        r = torch.sigmoid(x[:, :H] + (acc[:, :H] + b[:H]))
        z = torch.sigmoid(x[:, H:2 * H] + (acc[:, H:2 * H] + b[H:2 * H]))
        n = torch.tanh(x[:, 2 * H:] + r * (acc[:, 2 * H:] + b[2 * H:]))
        h = (1.0 - z) * n + z * h
        ys.append(h.to(BF16))
    return torch.stack(ys, dim=1)


def _bf16_inputs(R, T, seed):
    rng = np.random.default_rng(seed)
    arrs = [0.5 * rng.standard_normal((R, T, 768)), rng.standard_normal((256, 768)) / 16,
            0.1 * rng.standard_normal(768), 0.1 * rng.standard_normal((R, 256))]
    return [torch.from_numpy(a.astype(np.float32)).to(BF16) for a in arrs]


@pytest.mark.parametrize("R,T", [(2, 2000), (128, 48)])
def test_split_carry_emulation_matches_plain_and_jax(R, T):
    """The split-carry product keeps the f32-carry contract: over 2000
    steps (R=2, the 600 s call's shard rows) and at the inference rows
    (R=128, short), within the card's bar for K3 in bf16 (two bf16
    roundings at the largest output) of the port's plain version and of
    JAX's Pallas kernel in interpret mode on the same bf16 inputs."""
    args = _bf16_inputs(R, T, seed=R)
    got = _emulate(*args)
    want, _ = k3.gru_recurrence_reference(*args)
    assert want.dtype == BF16
    tol = bf16_tol(want.float(), 2)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    jys, _ = gru_recurrence_pallas(*(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in args))
    jys = torch.from_numpy(np.array(jys.astype(jnp.float32)))
    torch.testing.assert_close(got.float(), jys, atol=tol, rtol=0)


def _emulate_f32(x_proj, w_hh, b_hh, h0, w_d, b_d, ln_w, ln_b, N):
    """The float32 cluster kernel's schedule in torch, tile by tile of N
    rows (rows past R zero): step t takes h_{t-1} from buffer t % 3, sums
    the product over the eight 32-unit k-slices in pairs and the pairs in
    order, writes h_t into buffer (t + 1) % 3; after the step, the statistics
    of the outputs in flight (t = 2m + 3: the mean and squared deviations of
    output m; t = 2m + 4: its LayerNorm, GELU and store), then the conv of
    frame t - 1 into the three open outputs a0..a2 (an odd frame taps 3, 1;
    an even frame 2m taps 4, 2, 0, then output m is summed with b_d into
    its slot m % 2 and the outputs shift). The loop runs 2 ceil(T/2) + 3
    steps, x_proj zero past T."""
    R, T, _ = x_proj.shape
    H = w_hh.shape[0]
    n_out = (T + 1) // 2
    out = torch.full((R, n_out, H), float("nan"))
    gelu = lambda y: 0.5 * y * (1.0 + torch.erf(y * 0.70710678118654752))
    for r0 in range(0, R, N):
        rows = min(N, R - r0)
        xt = torch.zeros(N, T + 2 * n_out + 3, 3 * H)
        xt[:rows, :T] = x_proj[r0:r0 + rows]
        bufs = [torch.zeros(N, H), None, None]
        bufs[0][:rows] = h0[r0:r0 + rows]
        hc = bufs[0].clone()
        a = [torch.zeros(N, H) for _ in range(3)]
        ysum, mean, var = [None, None], [None, None], [None, None]
        for t in range(2 * n_out + 3):
            cur = bufs[t % 3]
            parts = [cur[:, 32 * k:32 * k + 32] @ w_hh[32 * k:32 * k + 32] for k in range(8)]
            pairs = [parts[2 * i] + parts[2 * i + 1] for i in range(4)]
            hp = ((pairs[0] + pairs[1]) + pairs[2]) + pairs[3]
            x = xt[:, t]
            r = torch.sigmoid(x[:, :H] + (hp[:, :H] + b_hh[:H]))
            z = torch.sigmoid(x[:, H:2 * H] + (hp[:, H:2 * H] + b_hh[H:2 * H]))
            n = torch.tanh(x[:, 2 * H:] + r * (hp[:, 2 * H:] + b_hh[2 * H:]))
            hc = (1.0 - z) * n + z * hc
            bufs[(t + 1) % 3] = hc
            if t % 2 == 1 and t >= 3 and (t - 3) // 2 < n_out:
                m = (t - 3) // 2
                mean[m % 2] = ysum[m % 2].sum(-1, keepdim=True) / H
                var[m % 2] = ((ysum[m % 2] - mean[m % 2]) ** 2).sum(-1, keepdim=True)
            if t % 2 == 0 and t >= 4 and (t - 4) // 2 < n_out:
                j = (t - 4) // 2
                y = (ysum[j % 2] - mean[j % 2]) * torch.rsqrt(var[j % 2] / H + 1e-5) * ln_w + ln_b
                out[r0:r0 + rows, j] = gelu(y)[:rows]
            if t >= 1:
                f = t - 1
                taps = (3, 1) if f % 2 else (4, 2, 0)
                for i, tap in enumerate(taps):
                    a[i] = a[i] + cur @ w_d[tap]
                if f % 2 == 0:
                    m = f // 2
                    if m < n_out:
                        ysum[m % 2] = b_d + a[0]
                    a = [a[1], a[2], torch.zeros(N, H)]
    return out


@pytest.mark.parametrize("R,T,N", [(3, 33, 2), (5, 48, 4), (1, 1, 2), (2, 2, 2), (9, 21, 9)])
def test_f32_cluster_schedule_matches_plain_and_jax(R, T, N):
    """The float32 kernel's schedule (tiles of N rows with zero rows past R,
    odd and even T, T = 1 and 2) gives K2's output: within the card's
    float32 bar for K2 (5e-5) of the port's plain version and of JAX's GRU
    scan and causal downsample on the same inputs (x_proj = z W_ih + b_ih)."""
    rng = np.random.default_rng(R * 100 + T)
    f = lambda *shape, sc=0.2: torch.from_numpy((sc * rng.standard_normal(shape)).astype(np.float32))
    H = 256
    z, w_ih, b_ih = f(R, T, H, sc=1.0), f(H, 3 * H, sc=0.06), f(3 * H)
    w_hh, b_hh, h0 = f(H, 3 * H, sc=0.06), f(3 * H), torch.zeros(R, H)
    w_d, b_d, ln_w, ln_b = f(5, H, H, sc=0.03), f(H), 1 + f(H), f(H)
    x_proj = z @ w_ih + b_ih
    args = [x_proj, w_hh, b_hh, h0, w_d, b_d, ln_w, ln_b]
    got = _emulate_f32(*args, N)
    assert got.shape == (R, (T + 1) // 2, H) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, k2.gru_downsample_reference(*args), atol=5e-5, rtol=0)
    j = lambda t: jnp.asarray(t.numpy())
    ys, _ = jgru({"w_ih": j(w_ih), "w_hh": j(w_hh), "b_ih": j(b_ih), "b_hh": j(b_hh)}, j(z), impl="scan")
    d = {"downsample": {"conv": {"w": j(w_d), "b": j(b_d)}, "ln": {"w": j(ln_w), "b": j(ln_b)}}}
    want = torch.from_numpy(np.array(_downsample(d, ys)))
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)


def _emulate_f32_recurrence(x_proj, w_hh, b_hh, h0, N):
    """The float32 K3 kernel's schedule in torch, tile by tile of N rows
    (rows past R zero, never stored): step t takes h_{t-1} from buffer t % 2,
    sums the product over the eight 32-unit k-slices in pairs (the shuffle)
    and the pairs in order (the gate math), rows 16 at a time, writes h_t
    into buffer (t + 1) % 2 and ys[:, t]."""
    R, T, _ = x_proj.shape
    H = w_hh.shape[0]
    ys = torch.full((R, T, H), float("nan"))
    for r0 in range(0, R, N):
        rows = min(N, R - r0)
        xt = torch.zeros(N, T, 3 * H)
        xt[:rows] = x_proj[r0:r0 + rows]
        bufs = [torch.zeros(N, H), None]
        bufs[0][:rows] = h0[r0:r0 + rows]
        hc = bufs[0].clone()
        for t in range(T):
            cur = bufs[t % 2]
            hp = torch.empty(N, 3 * H)
            for n0 in range(0, N, 16):
                c = cur[n0:n0 + 16]
                parts = [c[:, 32 * k:32 * k + 32] @ w_hh[32 * k:32 * k + 32] for k in range(8)]
                pairs = [parts[2 * i] + parts[2 * i + 1] for i in range(4)]
                hp[n0:n0 + 16] = ((pairs[0] + pairs[1]) + pairs[2]) + pairs[3]
            x = xt[:, t]
            r = torch.sigmoid(x[:, :H] + (hp[:, :H] + b_hh[:H]))
            z = torch.sigmoid(x[:, H:2 * H] + (hp[:, H:2 * H] + b_hh[H:2 * H]))
            n = torch.tanh(x[:, 2 * H:] + r * (hp[:, 2 * H:] + b_hh[2 * H:]))
            hc = (1.0 - z) * n + z * hc
            bufs[(t + 1) % 2] = hc
            ys[r0:r0 + rows, t] = hc[:rows]
    return ys


@pytest.mark.parametrize("R,T,N", [(1, 1, 2), (2, 2, 2), (3, 33, 2), (5, 48, 4), (9, 21, 8), (17, 40, 16),
                                   (33, 12, 32), (4, 2000, 4)])
def test_f32_recurrence_schedule_matches_plain_and_jax(R, T, N):
    """The float32 K3 kernel's schedule (tiles of N rows with zero rows past
    R, 32 rows as two halves of 16, T = 1 and 2, the frozen step's 2000
    steps) with a nonzero h0 gives K3's output: within the card's float32
    bar for K3 (5e-6) of the port's plain version and of JAX's GRU scan on
    the same inputs (x_proj = z W_ih + b_ih)."""
    rng = np.random.default_rng(R * 1000 + T)
    f = lambda *shape, sc=0.2: torch.from_numpy((sc * rng.standard_normal(shape)).astype(np.float32))
    H = 256
    z, w_ih, b_ih = f(R, T, H, sc=1.0), f(H, 3 * H, sc=0.06), f(3 * H)
    w_hh, b_hh, h0 = f(H, 3 * H, sc=0.06), f(3 * H), f(R, H, sc=0.5)
    x_proj = z @ w_ih + b_ih
    got = _emulate_f32_recurrence(x_proj, w_hh, b_hh, h0, N)
    assert got.shape == (R, T, H) and bool(torch.isfinite(got).all())
    want, _ = k3.gru_recurrence_reference(x_proj, w_hh, b_hh, h0)
    torch.testing.assert_close(got, want, atol=5e-6, rtol=0)
    j = lambda t: jnp.asarray(t.numpy())
    ys, _ = jgru({"w_ih": j(w_ih), "w_hh": j(w_hh), "b_ih": j(b_ih), "b_hh": j(b_hh)}, j(z), j(h0), impl="scan")
    torch.testing.assert_close(got, torch.from_numpy(np.array(ys)), atol=5e-6, rtol=0)


# ------------------------------------------------------------ the wrappers --
def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    """bf16 at H = 256, the cluster kernel's route on the card: on CPU
    tensors both wrappers return their plain versions and the launch ledger
    does not move."""
    x_proj, w_hh, b_hh, h0 = _bf16_inputs(3, 9, seed=3)
    rng = np.random.default_rng(4)
    ds = [torch.from_numpy(a.astype(np.float32)).to(BF16) for a in
          (rng.standard_normal((5, 256, 256)) / 36, 0.1 * rng.standard_normal(256),
           1 + 0.1 * rng.standard_normal(256), 0.1 * rng.standard_normal(256))]
    before = _build.launch_counts()
    ys, h_last = k3.gru_recurrence(x_proj, w_hh, b_hh, h0)
    assert torch.equal(ys, k3.gru_recurrence_reference(x_proj, w_hh, b_hh, h0)[0])
    assert torch.equal(h_last, ys[:, -1])
    out = k2.gru_downsample_fused(x_proj, w_hh, b_hh, h0, *ds)
    assert out.shape == (3, 5, 256) and out.dtype == BF16
    assert torch.equal(out, k2.gru_downsample_reference(x_proj, w_hh, b_hh, h0, *ds))
    assert _build.launch_counts() == before


def test_smem_reckoning_is_the_sum_of_its_regions():
    """smem_bytes at K2's 16 rows, written out region by region."""
    w_d = 3 * 32 * 1024
    h_buffers = 2 * 2 * 16 * 256 * 2
    x_ring = 3 * 16 * 3 * 32 * 2
    k_halves = 2 * (2 * 128 * 2 * 16 * 4)  # the GRU's and the conv's
    stats = (4 * 16 * 32 + 2 * 8 * 16 + 16) * 4
    mbarriers = 2 * 8
    assert gru_cluster.smem_bytes(16, 8, True) == 1024 + w_d + h_buffers + x_ring + k_halves + stats + mbarriers
    assert gru_cluster.smem_bytes(16, 8, True) == 216_144


def test_f32_cpu_tensors_count_no_kernel():
    """float32 at H = 256, the f32 cluster route on the card: CPU tensors
    take the plain version and move neither K3's launch count nor its
    count by kernel."""
    rng = np.random.default_rng(8)
    args = [torch.from_numpy(a.astype(np.float32)) for a in
            (0.5 * rng.standard_normal((3, 5, 768)), rng.standard_normal((256, 768)) / 16,
             0.1 * rng.standard_normal(768), 0.1 * rng.standard_normal((3, 256)))]
    before = _build.launch_counts()
    ys, _ = k3.gru_recurrence(*args)
    assert torch.equal(ys, k3.gru_recurrence_reference(*args)[0])
    assert _build.launch_counts()["gru_recurrence"] == before["gru_recurrence"]
    assert set(before["gru_recurrence"]) == {"cluster bfloat16", "cluster float32", "block"}
