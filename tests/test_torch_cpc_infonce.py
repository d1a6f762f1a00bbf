"""PyTorch port: the CPC loss's InfoNCE scoring (``ops/cpc_infonce.py``,
``csrc/cpc_infonce.cu``, K14).

On the CPU: which tensors take the kernels and which the plain version
(the CPU, bfloat16, other widths and head counts take
``infonce_reference`` and count no launch), the shapes the wrapper
refuses, the layout of the predictions the kernels are handed, and
``cpc_loss`` on the CPU computing exactly the plain version. The port's CPC
loss is held to the JAX package by ``tests/test_torch_cpc.py``.

The kernels run only on the card; they are held to the plain version in
float64 by ``tests/test_torch_cuda.py``.
"""

import math

import pytest
import torch

from voiceactivityprojection_tpu_torch import VapConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import encoder_from_jax, random_params_tree
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import cpc_infonce as k14
from voiceactivityprojection_tpu_torch.train import cpc_pretrain

pytestmark = pytest.mark.train

def _inputs(B, T, K, N, C=256, seed=0, dtype=torch.float32, ties=False):
    """z (B, T, C), preds (K, B, T - K, C) at scores of a few units, idx
    (B, T - K, N); with ``ties`` every third row's first negative is its
    head-1 positive, without no negative is any of its row's positives."""
    g = torch.Generator().manual_seed(seed)
    Tc = T - K
    z = torch.randn(B, T, C, generator=g).to(dtype)
    preds = (torch.randn(K, B, Tc, C, generator=g) / math.sqrt(C)).to(dtype)
    idx = torch.randint(0, B * T, (B, Tc, N), generator=g)
    own = torch.arange(B)[:, None] * T + torch.arange(Tc)[None]  # a row's own frame, never its positive
    ahead = idx - own[..., None]
    idx = torch.where((ahead >= 1) & (ahead <= K), own[..., None], idx)
    if ties:
        for b in range(B):
            for t in range(0, Tc, 3):
                idx[b, t, 0] = b * T + t + 1
    return z, preds, idx


def _launched(before):
    return _build.launch_totals(_build.launches_since(before))["cpc_infonce"]


# ---------------------------------------------------------------- the routes
@pytest.mark.parametrize("device, z_dtype, preds_dtype, width, heads, takes", [
    ("cuda", torch.float32, torch.float32, 256, 12, True),
    ("cuda", torch.float32, torch.float32, 256, 1, True),
    ("cuda", torch.float32, torch.float32, 256, 16, True),
    ("cpu", torch.float32, torch.float32, 256, 12, False),
    ("cuda", torch.bfloat16, torch.bfloat16, 256, 12, False),
    ("cuda", torch.float64, torch.float64, 256, 12, False),
    ("cuda", torch.float32, torch.bfloat16, 256, 12, False),
    ("cuda", torch.bfloat16, torch.float32, 256, 12, False),
    ("cuda", torch.float32, torch.float32, 128, 12, False),
    ("cuda", torch.float32, torch.float32, 512, 12, False),
    ("cuda", torch.float32, torch.float32, 256, 17, False),
])
def test_route_by_device_dtype_width_and_heads(device, z_dtype, preds_dtype, width, heads, takes):
    assert k14.kernel_takes(device, z_dtype, preds_dtype, width, heads) is takes


@pytest.mark.parametrize("K, C, dtype", [(12, 256, torch.float32), (3, 256, torch.bfloat16), (4, 64, torch.float32),
                                         (17, 256, torch.float32)],
                         ids=["cpu", "bfloat16", "width-64", "17-heads"])
def test_cpu_and_other_tensors_take_the_reference_without_a_launch(K, C, dtype):
    z, preds, idx = _inputs(2, K + 9, K, 6, C=C, dtype=dtype)
    before = _build.launch_counts()
    loss, aux = k14.infonce(z, preds, idx)
    assert _launched(before) == 0 and _build.launch_counts() == before
    want_loss, want = k14.infonce_reference(z, preds, idx)
    assert torch.equal(loss, want_loss) and loss.dtype == dtype
    assert aux.keys() == want.keys() == {"cpc_loss", "cpc_acc", "cpc_acc_k1", "cpc_acc_k12"}
    for name in aux:
        assert torch.equal(aux[name], want[name]), name


@pytest.mark.parametrize("what, match", [
    ("idx-2d", "idx must be"),
    ("idx-batch", "idx must be"),
    ("idx-contexts", "idx must be"),
    ("idx-no-negatives", "idx must be"),
    ("idx-float", "integer"),
    ("idx-bool", "integer"),
    ("preds-batch", "preds must be"),
    ("preds-width", "preds must be"),
    ("preds-past-T", "preds must be"),
    ("preds-no-heads", "preds must be"),
    ("z-2d", "z must be"),
])
def test_wrapper_refuses_shapes(what, match):
    B, T, K, N = 2, 14, 3, 5
    z, preds, idx = _inputs(B, T, K, N, C=8)
    Tc = T - K
    bad = {
        "idx-2d": lambda: (z, preds, idx[0]),
        "idx-batch": lambda: (z, preds, idx[:1]),
        "idx-contexts": lambda: (z, preds, idx[:, 1:]),
        "idx-no-negatives": lambda: (z, preds, idx[..., :0]),
        "idx-float": lambda: (z, preds, idx.float()),
        "idx-bool": lambda: (z, preds, idx > 3),
        "preds-batch": lambda: (z, preds[:, :1], idx),
        "preds-width": lambda: (z, preds[..., :4], idx),
        "preds-past-T": lambda: (z, torch.zeros(K + 1, B, Tc, 8), idx),
        "preds-no-heads": lambda: (z, preds[:0], idx),
        "z-2d": lambda: (z[0], preds, idx),
    }[what]
    with pytest.raises(ValueError, match=match):
        k14.infonce(*bad())


@pytest.mark.parametrize("K", [1, 4, 12])
def test_cpc_loss_on_the_cpu_is_the_plain_version(K):
    """``cpc_loss`` on the CPU: the plain version on the encoder's z and the
    heads' predictions, bit for bit, loss, metrics and gradients."""
    enc = encoder_from_jax(random_params_tree(VapConfig(), seed=0)["encoder"])
    heads = cpc_pretrain.init_cpc_heads(torch.Generator().manual_seed(1), K, 256, 256)
    wave = 0.1 * torch.randn(2, 3200, generator=torch.Generator().manual_seed(2))
    T = cpc_pretrain.encoded_frames(3200)
    idx = cpc_pretrain.sample_negatives(torch.Generator().manual_seed(3), 2, T - K, 9, 2 * T)
    before = _build.launch_counts()
    loss, aux = cpc_pretrain.cpc_loss(enc, heads, wave, idx, K)
    assert _launched(before) == 0
    grads = torch.autograd.grad(loss, [heads.W, *enc.gAR.parameters()])

    z, c = cpc_pretrain.cpc_forward(enc, wave)
    preds = torch.einsum("btc,kcd->kbtd", c[:, :T - K], heads.W)
    want_loss, want = k14.infonce_reference(z, preds, idx)
    want_grads = torch.autograd.grad(want_loss, [heads.W, *enc.gAR.parameters()])
    assert torch.equal(loss, want_loss)
    for name in want:
        assert torch.equal(aux[name], want[name]), name
    for got, ref in zip(grads, want_grads):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("what", ["batch", "contexts"])
def test_cpc_loss_refuses_negatives_of_another_shape(what):
    """``cpc_loss`` hands the negatives to ``infonce``, whose shape check
    refuses an idx that is not (B, T - K, N)."""
    enc = encoder_from_jax(random_params_tree(VapConfig(), seed=0)["encoder"])
    heads = cpc_pretrain.init_cpc_heads(torch.Generator().manual_seed(1), 4, 256, 256)
    wave = 0.1 * torch.randn(2, 3200, generator=torch.Generator().manual_seed(2))
    T = cpc_pretrain.encoded_frames(3200)
    B, Tc = (1, T - 4) if what == "batch" else (2, T - 5)
    idx = cpc_pretrain.sample_negatives(torch.Generator().manual_seed(3), B, Tc, 9, 2 * T)
    with pytest.raises(ValueError, match="idx must be"):
        cpc_pretrain.cpc_loss(enc, heads, wave, idx, 4)


@pytest.mark.parametrize("layout, kept", [
    ("einsum", True),        # the heads' einsum output, (B, Tc, K, C) as it lies
    ("contiguous", True),
    ("width-strided", False),
    ("row-unaligned", False),
])
def test_kernels_take_the_predictions_as_they_lie_where_rows_are_aligned(layout, kept):
    """``_kernel_preds``: rows of C contiguous on 16-byte boundaries are
    handed as they lie; anything else is copied contiguous first."""
    K, B, Tc, C = 3, 2, 5, 8
    preds = {
        "einsum": lambda: torch.randn(B, Tc, K, C).permute(2, 0, 1, 3),
        "contiguous": lambda: torch.randn(K, B, Tc, C),
        "width-strided": lambda: torch.randn(K, B, Tc, 2 * C)[..., ::2],
        "row-unaligned": lambda: torch.randn(K, B, Tc, C + 1)[..., :C],
    }[layout]()
    got = k14._kernel_preds(preds)
    assert (got is preds) is kept
    assert torch.equal(got, preds)
    assert got.stride(3) == 1 and all(s % 4 == 0 for s in got.stride()[:3])
