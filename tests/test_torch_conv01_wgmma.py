"""PyTorch port: the bfloat16 design of K11 (``csrc/conv01_wgmma.cuh``,
conv0 + conv1 on ``wgmma``), checked on the CPU where no kernel runs.

- the kernel's arithmetic emulated in torch (bf16 inputs, f32 products and
  sums, conv0 as the 16-tap product, conv0 rounded to bf16, literal zeros
  outside [0, n0)) against the plain version and JAX's ``fused_conv01`` in
  interpret mode;
- the polyphase index map of conv0 in shared memory, enumerated: what
  conv1's A operand reads for every tile edge, tap and output;
- the route rule and the shared-memory reckoning against the CUDA source;
- CPU tensors take the plain version and count no launch.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voiceactivityprojection_tpu.ops import conv_fused as jcf
from voiceactivityprojection_tpu_torch import VapConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import encoder_from_jax, random_params_tree
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import conv_fused as k11

from _torch_tol import bf16_tol

pytestmark = pytest.mark.encoder

torch.set_num_threads(2)
BF16 = torch.bfloat16
HEADER = (_build.CSRC_DIR / "conv01_wgmma.cuh").read_text()
SOURCE = (_build.CSRC_DIR / "conv_fused.cu").read_text()
# n whose n1 is one past a tile edge: n0 = 1028, n1 = 257 = 2 * 128 + 1
EDGE_N = 5139


def _const(name, src=HEADER):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@functools.lru_cache(maxsize=None)
def _header_values():
    """Every namespace-scope ``constexpr int`` of the header, its integer arithmetic
    evaluated in order."""
    vals = {"wg::TILE_BYTES": 8192}
    for decl in re.findall(r"^constexpr int ([^;]+);", HEADER, re.M):  # namespace scope
        for item in decl.split(","):
            name, expr = (part.strip() for part in item.split("=", 1))
            for k, v in vals.items():
                expr = re.sub(rf"(?<![\w:]){re.escape(k)}(?!\w)", str(v), expr)
            assert re.fullmatch(r"[\d\s()+*/-]+", expr), (name, expr)
            vals[name] = eval(expr.replace("/", "//"), {})  # noqa: S307 - integer arithmetic only
    return vals


def _bf16(a):
    return np.asarray(torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float())


@pytest.fixture(scope="module")
def weights():
    """The first two layers at bf16-representable values: a JAX tree and the
    port's layers in bf16."""
    tree = jax.tree.map(_bf16, random_params_tree(VapConfig(), seed=11)["encoder"])
    enc = encoder_from_jax(tree)
    layers = [tuple(t.detach().to(BF16) for t in (l.conv.w, l.conv.b, l.norm.w, l.norm.b))
              for l in enc.gEncoder[:2]]
    return tree, layers


def _norm_relu(z, g, e):
    mean = z.mean(-1, keepdim=True)
    var = ((z - mean) ** 2).sum(-1, keepdim=True) / (z.shape[-1] - 1)
    return torch.relu((z - mean) * torch.rsqrt(var + 1e-5) * g + e)


def emulate(layers, x):
    """The bf16 kernel's arithmetic in torch: bf16 samples and weights, f32
    products and sums; conv0 over 16 taps (w0's rows 10-15 zero, samples
    outside [0, n) zero), bias, ChannelNorm, ReLU, rounded to bf16; conv1
    over the conv0 positions 4u - 2 + t, literal zeros outside [0, n0);
    bias, ChannelNorm, ReLU, rounded to bf16."""
    w0, b0, g0, e0 = (t.float() for t in layers[0])
    w1, b1, g1, e1 = (t.float() for t in layers[1])
    R, n = x.shape
    n0 = (n + 2 * k11.P0 - k11.K0) // k11.S0 + 1
    n1 = k11.out_len(n)
    xp = torch.zeros(R, k11.S0 * (n0 - 1) + k11.TAPS0)
    xp[:, k11.P0:k11.P0 + n] = x.float()
    w0p = torch.zeros(k11.TAPS0, k11.C)
    w0p[:k11.K0] = w0[:, 0]
    z0 = _norm_relu(xp.unfold(1, k11.TAPS0, k11.S0) @ w0p + b0, g0, e0).to(BF16).float()
    z0p = torch.nn.functional.pad(z0, (0, 0, k11.P1, k11.P1))
    cols = z0p.unfold(1, k11.K1, k11.S1)[:, :n1].transpose(2, 3).reshape(R, n1, k11.K1 * k11.C)
    return _norm_relu(cols @ w1.reshape(k11.K1 * k11.C, k11.C) + b1, g1, e1).to(BF16)


def _x(R, n, seed=0):
    return torch.from_numpy((0.1 * np.random.default_rng(seed).standard_normal((R, n))).astype(np.float32)).to(BF16)


# ---------------------------------------------------------- (a) arithmetic --
@pytest.mark.parametrize("n", [16000, 12345, 161, EDGE_N])
def test_emulation_matches_plain_bf16(weights, n):
    """The emulated kernel against ``reference_unfused`` in bf16, at the
    card test's bar (four bf16 steps)."""
    _, layers = weights
    x = _x(2, n, seed=n)
    with torch.no_grad():
        got = emulate(layers, x)
        want = k11.reference_unfused(layers, x)
    assert got.shape == want.shape == (2, k11.out_len(n), 256)
    torch.testing.assert_close(got.float(), want.float(), atol=bf16_tol(want, 4), rtol=0)


@pytest.mark.parametrize("n", [16000, 12345, 161, EDGE_N])
def test_emulation_matches_jax_kernel_interpret_bf16(weights, n):
    """The emulated kernel against JAX's Pallas kernel (interpret mode, as
    ``test_plain_matches_jax_kernel_interpret`` runs it) on the same bf16
    inputs, at four bf16 steps."""
    tree, layers = weights
    x = _x(2, n, seed=n + 1)
    want = np.asarray(jcf.fused_conv01(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree),
                                       jnp.asarray(x.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = emulate(layers, x).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=bf16_tol(want, 4), rtol=0)


def test_padded_taps_read_only_zero_weights_and_in_range_samples():
    """conv0's im2col: tile position p reads samples 5 p + k of the CTA's
    buffer (k < 16); the buffer holds every one of them, and the samples
    past the 10 real taps meet w0's zero rows."""
    vals = _header_values()
    npos, buf = vals["NPOS"], vals["NSAMP_BUF"]
    assert npos == k11.conv0_positions() == 516 and buf == k11.SAMPLE_BUF
    assert k11.S0 * (npos - 1) + k11.TAPS0 - 1 < buf
    assert vals["NSAMP"] == k11.S0 * (npos - 1) + k11.K0 == 2585  # the samples a tile reads
    assert vals["TAPS0"] == k11.TAPS0 and vals["K0"] == k11.K0 < k11.TAPS0


# ------------------------------------------------------- (b) the index map --
def _z0_chunk(p, c8):
    """``z0_chunk``: the byte offset of channel chunk c8 (of the current
    64-channel group) of tile position p: plane p % 4, row p // 4."""
    v = _header_values()
    row = v["OFF_Z0"] + (p & 3) * v["PLANE_BYTES"] + (p >> 2) * 128
    return row + ((c8 ^ ((row >> 7) & 7)) << 4)


def _ldmatrix_rows(load, kk, wgroup, warp):
    """The rows conv1's A fragment of stage load ``load``, k-step ``kk`` (of
    its two) comes from for warp ``warp`` of warpgroup ``wgroup``: lane l
    gives the address of its row (output 64 wgroup + 16 warp + l % 16) at
    channel chunk l // 16 of the k-step, as ``ldsm_x4`` is called. Returns
    {(matrix, row in matrix): (output, chunk, byte offset)}; matrix m of
    ldmatrix.x4 is fragment a_m (a0: rows 0-7, k 0-7; a1: rows 8-15, k
    0-7; a2: rows 0-7, k 8-15; a3: rows 8-15, k 8-15)."""
    k = load % 16
    tap = k >> 1
    out = {}
    for lane in range(32):
        j = 64 * wgroup + 16 * warp + (lane & 15)
        c8 = 4 * (k & 1) + 2 * kk + (lane >> 4)
        out[(lane // 8, lane % 8)] = (j, c8, _z0_chunk(4 * j + tap, c8))
    return out


def _load_row(i):
    """``load_row``: the W1 row of stage load i (group-major)."""
    g, k = divmod(i, 16)
    return (k >> 1) * 256 + 64 * g + k11.STAGE_ROWS * (k & 1)


def test_polyphase_map_is_one_to_one_and_in_its_region():
    addrs = {_z0_chunk(p, c8): (p, c8) for p in range(516) for c8 in range(8)}
    assert len(addrs) == 516 * 8
    lo = _header_values()["OFF_Z0"]
    assert min(addrs) >= lo and max(addrs) + 16 <= lo + k11.smem_regions()["conv0_planes"]
    assert all(a % 16 == 0 for a in addrs)


@pytest.mark.parametrize("n", [16000, 161, EDGE_N])
def test_polyphase_reads_give_position_4u_minus_2_plus_t_or_zero(n):
    """Every tile edge (the first tile and the ragged last one), every stage
    load, k-step, warp and ldmatrix row: the conv0 value conv1's A fragment
    holds is position 4u - 2 + t with the channels of its contraction index
    (a stored zero where that position lies outside [0, n0): only at the
    tile's ends)."""
    n0 = (n + 2 * k11.P0 - k11.K0) // k11.S0 + 1
    n1 = k11.out_len(n)
    tiles = -(-n1 // k11.TILE)
    where = {_z0_chunk(p, c8): (p, c8) for p in range(516) for c8 in range(8)}
    for tile in sorted({0, tiles - 1}):
        reads = {True: 0, False: 0}
        u0 = tile * k11.TILE
        p_first = k11.S1 * u0 - k11.P1
        for load in range(2048 // k11.STAGE_ROWS):
            g = load // 16
            for kk in range(2):
                w1_row = _load_row(load) + 16 * kk  # the k-step's first W1 row: tap * 256 + channel
                tap, k = divmod(w1_row, 256)
                assert k // 64 == g
                for wgroup in range(2):
                    for warp in range(4):
                        for (m, row), (r, c8, addr) in _ldmatrix_rows(load, kk, wgroup, warp).items():
                            # fragment a_m: rows 8 (m % 2) .., k 8 (m // 2) ..
                            assert r == 64 * wgroup + 16 * warp + 8 * (m % 2) + row
                            assert 64 * g + 8 * c8 == k + 8 * (m // 2)
                            p, pc8 = where[addr]
                            assert (p, pc8) == (4 * r + tap, c8)
                            gp = p_first + p
                            assert gp == 4 * (u0 + r) - 2 + tap
                            reads[0 <= gp < n0] += 1
        # zero rows: the left padding in the first tile, past n0 in the last
        assert reads[False] > 0 if tile in (0, tiles - 1) else True
        # conv0's samples: tile position p reads global samples 5 gp - 3 + k
        s_first = k11.S0 * p_first - k11.P0
        for p in (0, 515):
            assert s_first + k11.S0 * p == k11.S0 * (p_first + p) - k11.P0


def test_w1_stage_loads_cover_the_contraction_once():
    """Stage loads run group-major (the 8 taps of input channels 64 g ..
    before group g + 1, as conv0's planes hold one group at a time); each
    holds 32 W1 rows, and together they cover the 2048 rows once."""
    rows = []
    for i in range(2048 // k11.STAGE_ROWS):
        first = _load_row(i)
        assert (first % 256) // 64 == i // 16
        rows.extend(range(first, first + k11.STAGE_ROWS))
    assert sorted(rows) == list(range(2048))
    body = HEADER[HEADER.index("__device__ __forceinline__ int load_row(int i)"):]
    assert "return (k >> 1) * C + 64 * g + STAGE_ROWS * (k & 1);" in body[:300]


# ------------------------------------------------------ (c) the route rule --
def test_rule_matches_the_cuda_source():
    """bf16 takes the wgmma kernel, f32 the 3xTF32 kernel of
    csrc/conv01_tf32x3.cuh; the wrapper's constants are the header's."""
    for name, value in (("TU", k11.TILE), ("STAGES", k11.STAGES), ("STAGE_ROWS", k11.STAGE_ROWS),
                        ("TAPS0", k11.TAPS0), ("NSAMP_BUF", k11.SAMPLE_BUF)):
        assert _const(name) == value, name
    body = SOURCE[SOURCE.index('extern "C" int vap_conv01('):SOURCE.index('extern "C" void vap_conv01_kernel_launches(')]
    assert re.search(r"if \(dtype == vap::kBF16\)\s*return conv01_bf16\(", body)
    assert re.search(r"if \(dtype == vap::kF32\) return conv01_f32\(", body)
    assert "VAP_DISPATCH_DTYPE" not in body and not re.search(r"\bconv01_kernel\b", SOURCE)
    assert k11.route(torch.bfloat16) == "wgmma bfloat16" and k11.route(torch.float32) == "wgmma 3xtf32"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k11.route(torch.float16)
    assert set(k11.DESIGN) == {"bfloat16", "float32"}


# -------------------------------------------------- (d) the shared memory --
def test_smem_reckoning_matches_the_header_region_by_region():
    """Each region of ``smem_regions`` is the header's: the offsets'
    differences, evaluated from its constexpr lines; the sum fits one CTA
    an SM."""
    vals = _header_values()
    regions = k11.smem_regions()
    spans = {"w1_ring": ("OFF_RING", "OFF_W0"), "w0_padded": ("OFF_W0", "OFF_A0"),
             "conv0_im2col": ("OFF_A0", "OFF_Z0"), "conv0_planes": ("OFF_Z0", "OFF_SAMP"),
             "samples": ("OFF_SAMP", "OFF_PARAM"), "norm_params": ("OFF_PARAM", "OFF_STATS"),
             "conv0_stats": ("OFF_STATS", "OFF_BARS"), "mbarriers": ("OFF_BARS", "SMEM_USED")}
    for region, (a, b) in spans.items():
        assert vals[b] - vals[a] == regions[region], region
    assert vals["SMEM_BYTES"] == k11.smem_bytes() == vals["SMEM_USED"] + regions["alignment_slack"]
    assert regions["conv0_planes"] == 66_048 and regions["w1_ring"] == 7 * 16_384
    assert k11.smem_bytes() <= k11.MAX_SMEM
    assert re.search(r"static_assert\(SMEM_BYTES <= 232448", HEADER)


# ----------------------------------------------------- (e) the CPU's route --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version_uncounted(weights, dtype):
    _, layers = weights
    layers = [tuple(t.to(dtype) for t in l) for l in layers]
    x = _x(2, 3200, seed=3).to(dtype)
    before = _build.launch_counts()
    with torch.no_grad():
        got = k11.fused_conv01(layers, x)
        want = k11.reference_unfused(layers, x)
    assert _build.launch_counts() == before
    assert torch.equal(got, want)
