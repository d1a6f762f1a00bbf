"""PyTorch port: the KV streamers' attention row (``ops/kv_attention.py``,
``csrc/kv_attention.cu``, K12).

On the CPU: the wrapper takes the plain version for CPU tensors and counts
no launch, and refuses bad shapes; an emulation of the kernel's schedule
(the valid slot ranges, the groups' online softmax over ``kUnroll`` slots a
step, the merge of the groups) held to the plain version; the C entry's
parameters against the wrapper's. The streamers on the CPU are held to the
JAX package by ``tests/test_torch_streaming.py``.

On the card (marked ``cuda``; they skip without one): the kernel against
the plain version over S, T, ``pos``, ``n_valid``, self and cross rows and
the head widths, and what it refuses. This file imports
neither JAX nor the JAX package, so it also runs without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kv_attention.py
"""

import math
import re
from pathlib import Path

import pytest
import torch

from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import kv_attention as k12
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes

pytestmark = pytest.mark.inference

SOURCE = (Path(k12.__file__).resolve().parents[1] / "csrc" / "kv_attention.cu").read_text()
# the card's bar: each row's largest gap within 2e-6 of its largest value
REL_BAR = 2e-6


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _inputs(S, H, T, Dh, pos, n_valid, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(S, 2, H, Dh, generator=g)
    k = torch.randn(S, 2, H, T, Dh, generator=g)
    v = torch.randn(S, 2, H, T, Dh, generator=g)
    n = torch.tensor(n_valid, dtype=torch.int32)
    slopes = alibi_slopes(H).float()
    return [t.to(device) for t in (q, k, v, slopes, n)] + [pos]


def _plain(q, k, v, slopes, n, pos, swap):
    """The plain row of the channels the kernel reads: ring channel 1 - c
    for query channel c when ``swap``."""
    dist = k12.slot_ages(pos, k.shape[3], q.device)
    if swap:
        k, v = k.flip(1), v.flip(1)
    return k12.attn_row_reference(q, k, v, slopes, dist, n, q.shape[2] * q.shape[3])


# ---------------------------------------------------------------- the wrapper
@pytest.mark.parametrize("swap", [False, True])
def test_cpu_tensors_take_the_plain_row_without_a_launch(swap):
    q, k, v, slopes, n, pos = _inputs(3, 2, 9, 8, 4, [1, 5, 9])
    before = _build.launch_counts()
    got = k12.kv_attention_row(q, k, v, slopes, pos, n, 16, swap=swap)
    assert _build.launch_counts() == before
    dist = k12.slot_ages(pos, 9, "cpu")
    want = (k12.attn_row_reference(q.flip(1), k, v, slopes, dist, n, 16).flip(1) if swap
            else k12.attn_row_reference(q, k, v, slopes, dist, n, 16))
    assert got.shape == (3, 2, 16) and torch.equal(got, want)
    # the swap reads ring channel 1 - c for query channel c
    torch.testing.assert_close(got, _plain(q, k, v, slopes, n, pos, swap), rtol=0, atol=1e-6)


def test_slot_ages():
    assert k12.slot_ages(2, 5, "cpu").tolist() == [2.0, 1.0, 0.0, 4.0, 3.0]


@pytest.mark.parametrize("bad, match", [
    (dict(q=(3, 1, 2, 8)), "q must be"),
    (dict(k=(3, 2, 2, 9, 4)), "q must be"),
    (dict(slopes=(3,)), "slopes must be"),
    (dict(n=(2,)), "n_valid"),
    (dict(pos=9), "outside"),
    (dict(pos=-1), "outside"),
])
def test_wrapper_refuses_shapes_on_any_device(bad, match):
    q, k, v, slopes, n, pos = _inputs(3, 2, 9, 8, 4, [1, 5, 9])
    q = torch.zeros(bad["q"]) if "q" in bad else q
    k = torch.zeros(bad["k"]) if "k" in bad else k
    slopes = torch.zeros(bad["slopes"]) if "slopes" in bad else slopes
    n = torch.zeros(bad["n"], dtype=torch.int32) if "n" in bad else n
    with pytest.raises(ValueError, match=match):
        k12.kv_attention_row(q, k, v, slopes, bad.get("pos", pos), n, 16)


# --------------------------------------------- the kernel's schedule, emulated
def _valid_ranges(pos, n, T):
    """The kernel's valid slots, ages 0 .. n - 1, as one or two ranges."""
    if n >= T:
        return [(0, T)]
    if pos - n + 1 >= 0:
        return [(pos - n + 1, pos + 1)]
    return [(0, pos + 1), (T + pos - n + 1, T)]


def _merge(parts):
    """(max, sum, unnormalised output) parts against their common max, as
    the kernel merges its groups."""
    M = max(m for m, _, _ in parts)
    w = [0.0 if m == -math.inf else math.exp(m - M) for m, _, _ in parts]
    return M, sum(l * wi for (_, l, _), wi in zip(parts, w)), sum(o * wi for (_, _, o), wi in zip(parts, w))


def _emulate(q, k, v, slopes, n_valid, pos, swap):
    """``kv_row_kernel`` in float64, CTA by CTA and group by group."""
    S, _, H, Dh = q.shape
    T = k.shape[3]
    lanes = Dh // 4
    groups = _constant("kThreads") // lanes
    unroll = _constant("kUnroll")
    step = groups * unroll
    scale = 1.0 / math.sqrt(H * Dh)
    qd, kd, vd = q.double(), k.double(), v.double()
    out = torch.empty(S, 2, H, Dh, dtype=torch.float64)
    for s in range(S):
        n = min(int(n_valid[s]), T)
        for c in range(2):
            cr = 1 - c if swap else c
            for h in range(H):
                K, V, qv = kd[s, cr, h], vd[s, cr, h], qd[s, c, h]
                state = [[-math.inf, 0.0, torch.zeros(Dh, dtype=torch.float64)] for _ in range(groups)]
                for lo, hi in _valid_ranges(pos, n, T):
                    for base in range(lo, hi, step):
                        for g in range(groups):
                            js = [base + u * groups + g for u in range(unroll)]
                            sc = [float(qv @ K[j]) * scale - float(slopes[h]) * ((pos - j) % T)
                                  if j < hi else -math.inf for j in js]
                            m, l, acc = state[g]
                            mx = max([m] + sc)
                            ref = 0.0 if mx == -math.inf else mx
                            alpha = math.exp(m - ref) if m != -math.inf else 0.0
                            l, acc = l * alpha, acc * alpha
                            for j, sj in zip(js, sc):
                                if sj != -math.inf:
                                    p = math.exp(sj - ref)
                                    l, acc = l + p, acc + p * V[j]
                            state[g] = [mx, l, acc]
                _, L, O = _merge(state)
                out[s, c, h] = O / L
    return out.reshape(S, 2, H * Dh).float()


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("case", [
    lambda T: (0, [1, 1]),                # a just-reset stream: only slot pos
    lambda T: (0, [T, 20]),               # full, and ages wrapping past slot 0
    lambda T: (T // 2, [5, T]),           # the middle
    lambda T: (T - 1, [T - 1, 12]),       # the last slot
    lambda T: (3, [9, T + 13]),           # two ranges; n_valid past T reads every slot
], ids=["reset", "wrapped", "middle", "last", "two-ranges"])
# 37 slots: one step of the loop at Dh = 32 (64 slots a step), 70: several
# steps at every Dh, so the online rescale between steps runs
@pytest.mark.parametrize("T", [37, 70])
def test_kernel_schedule_emulated_matches_plain(Dh, swap, case, T):
    pos, n_valid = case(T)
    H = 256 // Dh // 2  # two streams, half the model's heads: a small row count
    q, k, v, slopes, n, _ = _inputs(2, H, T, Dh, pos, n_valid, seed=Dh + T)
    got = _emulate(q, k, v, slopes, n, pos, swap)
    want = _plain(q, k, v, slopes, n, pos, swap)
    top = want.abs().amax(dim=-1, keepdim=True)
    assert float(((got - want).abs() / top).max()) <= REL_BAR


def test_emulation_reads_only_valid_slots():
    """A stream's slots outside its ages 0 .. n - 1 do not move its row,
    however large: the kernel never reads them."""
    T, pos = 37, 4
    q, k, v, slopes, n, _ = _inputs(1, 2, T, 32, pos, [7])
    stale = [j for j in range(T) if (pos - j) % T >= 7]
    k2, v2 = k.clone(), v.clone()
    k2[:, :, :, stale] = 1e4
    v2[:, :, :, stale] = float("nan")
    assert torch.equal(_emulate(q, k2, v2, slopes, n, pos, False), _emulate(q, k, v, slopes, n, pos, False))


def test_source_entry_matches_the_wrapper():
    """The C entry's parameters in the order ``_lib`` declares them."""
    sig = SOURCE[SOURCE.index('extern "C" int vap_kv_attention_row('):]
    sig = sig[:sig.index(")")]
    types = [p.strip().rsplit(" ", 1)[0] for p in sig.split("(", 1)[1].split(",")]
    want = ["const void*"] * 5 + ["void*"] + ["int"] * 4 + ["const void*", "float", "int", "void*"]
    assert types == want
    for dh in k12.HEAD_DIMS:
        assert f"case {dh}:" in SOURCE


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel compiles and runs only there")
    return torch.device("cuda")


def _n_valid(S, T):
    """Per-stream valid counts, stream by stream: full, partly filled, just
    reset (1), one short of full, half, and past T."""
    pattern = [T, max(1, T // 3), 1, max(1, T - 1), T // 2 + 1, T + 5]
    return [pattern[s % len(pattern)] for s in range(S)]


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("T", [1000, 37])
@pytest.mark.parametrize("S", [1, 3, 64, 512])
def test_kernel_matches_plain_on_the_card(cuda, S, T, Dh):
    H = 256 // Dh
    q, k, v, slopes, n, _ = _inputs(S, H, T, Dh, 0, _n_valid(S, T), seed=S + T + Dh, device=cuda)
    for pos in (0, T // 2, T - 1):
        for swap in (False, True):
            before = _build.launch_counts()
            got = k12.kv_attention_row(q, k, v, slopes, pos, n, H * Dh, swap=swap)
            torch.cuda.synchronize()
            assert _build.launch_totals(_build.launches_since(before))["kv_attention"] == 1
            want = _plain(q, k, v, slopes, n, pos, swap)
            top = want.abs().amax(dim=-1, keepdim=True)
            rel = float(((got - want).abs() / top).max())
            assert rel <= REL_BAR, (S, T, Dh, pos, swap, rel)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, slopes, n, pos = _inputs(2, 4, 37, 64, 3, [5, 37], device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k12.kv_attention_row(q, k.transpose(3, 4).contiguous().transpose(3, 4), v, slopes, pos, n, 256)
    with pytest.raises(ValueError, match="float32"):
        k12.kv_attention_row(q, k.double(), v, slopes, pos, n, 256)
    with pytest.raises(ValueError, match="float32"):
        k12.kv_attention_row(q.bfloat16(), k, v, slopes, pos, n, 256)
    with pytest.raises(ValueError, match="int32"):
        k12.kv_attention_row(q, k, v, slopes, pos, n.long(), 256)
    q48, k48, v48, s48, n48, _ = _inputs(2, 4, 37, 48, 3, [5, 37], device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        k12.kv_attention_row(q48, k48, v48, s48, pos, n48, 192)
