"""PyTorch port: the GRU cluster kernel's route, tiling and arithmetic
(``ops/gru_cluster.py``, ``csrc/gru_cluster.cuh``), on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it
against the plain versions there). Here: the tiling rule that the wrappers
of K2 and K3 apply; that rule against the constants and instantiations of
the CUDA source; a torch emulation of the kernel's arithmetic (the carry
split into two bf16 halves, each multiplied by the bf16 W_hh with an f32
sum, f32 gates) held to the port's plain version and to JAX's
``gru_recurrence_pallas`` at the bar the card uses; and the wrappers on
CPU tensors taking the plain versions without counting a launch.
"""

import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

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


def _resident(fused):
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
    for R in (1, 2, 32, 128):
        for dtype, H in ((torch.float32, 256), (BF16, 128), (BF16, 64), (torch.float32, 128)):
            t = gru_cluster.tiling(R, H, dtype, fused, _resident(fused))
            assert t.route == "block" and t.tiles == R


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


# ------------------------------------------------------------ the wrappers --
def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    """bf16 at H = 256, the cluster kernel's route on the card: on CPU
    tensors both wrappers return their plain versions and no counter moves."""
    x_proj, w_hh, b_hh, h0 = _bf16_inputs(3, 9, seed=3)
    rng = np.random.default_rng(4)
    ds = [torch.from_numpy(a.astype(np.float32)).to(BF16) for a in
          (rng.standard_normal((5, 256, 256)) / 36, 0.1 * rng.standard_normal(256),
           1 + 0.1 * rng.standard_normal(256), 0.1 * rng.standard_normal(256))]
    before = (k3.gru_recurrence.launches, k2.gru_downsample_fused.launches)
    ys, h_last = k3.gru_recurrence(x_proj, w_hh, b_hh, h0)
    assert torch.equal(ys, k3.gru_recurrence_reference(x_proj, w_hh, b_hh, h0)[0])
    assert torch.equal(h_last, ys[:, -1])
    out = k2.gru_downsample_fused(x_proj, w_hh, b_hh, h0, *ds)
    assert out.shape == (3, 5, 256) and out.dtype == BF16
    assert torch.equal(out, k2.gru_downsample_reference(x_proj, w_hh, b_hh, h0, *ds))
    assert (k3.gru_recurrence.launches, k2.gru_downsample_fused.launches) == before


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
