"""PyTorch port, the GRU backward (the CPU side of kernel K9): the plain
reverse recurrence ``gru_backward_reference`` and the autograd function
behind ``gru_recurrence`` against ``jax.grad`` of the JAX package's
``_scan_recurrence`` on the same numpy inputs, and against JAX's Pallas
backward in interpret mode (``slow``, as the JAX package's own kernel
tests are). The CUDA kernel is held against the plain version on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.ops.gru_pallas import _scan_recurrence
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import gru_recurrence as k3
from voiceactivityprojection_tpu_torch.ops.gru import gru

pytestmark = pytest.mark.encoder

torch.set_num_threads(2)

# float32, the same algebra summed in another order: 1e-5 of each
# gradient's largest magnitude (or 1e-5 absolute below 1)
REL = 1e-5
SHAPES = [(3, 33, 128), (2, 16, 128)]


def _inputs(B, T, H, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.5: (sc * rng.standard_normal(s)).astype(np.float32)
    return {"x_proj": r(B, T, 3 * H), "w_hh": r(H, 3 * H, sc=1 / np.sqrt(H)), "b_hh": r(3 * H, sc=0.1),
            "h0": r(B, H, sc=0.3), "cy": r(B, T, H, sc=1.0), "ch": r(B, H, sc=1.0)}


def _jax_grads(p):
    def loss(xp, w, b, h0):
        ys, h_last = _scan_recurrence(xp, w, b, h0)
        return jnp.sum(ys * p["cy"]) + jnp.sum(h_last * p["ch"])

    args = [jnp.asarray(p[k]) for k in ("x_proj", "w_hh", "b_hh", "h0")]
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(*args)]


def _close(got, want, names=("dx_proj", "dw_hh", "db_hh", "dh0")):
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=REL * max(float(np.abs(w).max()), 1.0), rtol=0, err_msg=name)


@pytest.mark.parametrize("B,T,H", SHAPES)
def test_gru_backward_plain_matches_jax_grad(B, T, H):
    p = _inputs(B, T, H)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    ys, _ = k3.gru_recurrence_reference(t["x_proj"], t["w_hh"], t["b_hh"], t["h0"])
    got = k3.gru_backward_reference(t["x_proj"], t["w_hh"], t["b_hh"], t["h0"], ys, t["cy"], t["ch"])
    _close(got, _jax_grads(p))


@pytest.mark.parametrize("B,T,H", SHAPES)
def test_gru_recurrence_autograd_matches_jax_grad(B, T, H):
    """The same gradients through ``gru_recurrence`` (the autograd function's
    CPU route: plain forward, ``gru_backward_reference`` backward)."""
    p = _inputs(B, T, H, seed=1)
    leaves = [torch.from_numpy(p[k]).requires_grad_() for k in ("x_proj", "w_hh", "b_hh", "h0")]
    before = _build.launch_counts()
    ys, h_last = k3.gru_recurrence(*leaves)
    assert ys.grad_fn is not None and torch.equal(h_last, ys[:, -1])
    loss = (ys * torch.from_numpy(p["cy"])).sum() + (h_last * torch.from_numpy(p["ch"])).sum()
    _close(torch.autograd.grad(loss, leaves), _jax_grads(p))
    assert _build.launch_counts() == before


def test_gru_backward_plain_is_the_gradient_of_the_plain_forward():
    """In float64 the reverse recurrence equals autograd through the plain
    forward loop (only the algebra is compared), with and without a
    separate ``h_last`` cotangent."""
    p = _inputs(2, 9, 32, seed=2)
    t = {k: torch.from_numpy(v).double() for k, v in p.items()}
    leaves = [t[k].clone().requires_grad_() for k in ("x_proj", "w_hh", "b_hh", "h0")]
    ys, h_last = k3.gru_recurrence_reference(*leaves)
    want = torch.autograd.grad((ys * t["cy"]).sum() + (h_last * t["ch"]).sum(), leaves)
    got = k3.gru_backward_reference(*(l.detach() for l in leaves), ys.detach(), t["cy"], t["ch"])
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12)
    folded = t["cy"].clone()
    folded[:, -1] += t["ch"]
    for g, w in zip(k3.gru_backward_reference(*(l.detach() for l in leaves), ys.detach(), folded), got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12)


def test_gru_backward_plain_casts_as_the_jax_backward():
    """bf16 inputs: h_{t-1} read from the bf16 ``ys``, gates in f32,
    ``dx_proj`` / ``dw_hh`` / ``db_hh`` / ``dh0`` in their inputs' dtypes
    (gru_pallas.py:430-436); within two bf16 steps, at the largest
    magnitude, of the f32 gradients of the same bf16-rounded inputs (the
    outputs' rounding plus the bf16 ``ys``'s; measured under one step)."""
    p = _inputs(2, 12, 32, seed=3)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    args16 = [t[k].bfloat16() for k in ("x_proj", "w_hh", "b_hh", "h0")]
    ys16, _ = k3.gru_recurrence_reference(*args16)
    got = k3.gru_backward_reference(*args16, ys16, t["cy"].bfloat16(), t["ch"].bfloat16())
    assert [g.dtype for g in got] == [torch.bfloat16] * 4
    args32 = [a.float() for a in args16]
    ys32, _ = k3.gru_recurrence_reference(*args32)
    want = k3.gru_backward_reference(*args32, ys32, t["cy"].bfloat16().float(), t["ch"].bfloat16().float())
    for g, w in zip(got, want):
        step = 2.0 ** (np.floor(np.log2(max(float(w.abs().max()), 1.0))) - 7)
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), atol=2 * step)


def test_model_gru_on_cpu_matches_the_autograd_function():
    """The model's CPU ``gru`` (the step loop under autograd, as JAX's scan)
    and ``gru_recurrence`` (the autograd function) give the same gradients."""
    rng = np.random.default_rng(4)
    H, C = 32, 16
    x = torch.from_numpy(rng.standard_normal((2, 11, C)).astype(np.float32))
    ws = [torch.from_numpy((0.2 * rng.standard_normal(s)).astype(np.float32)).requires_grad_()
          for s in ((C, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
    w_ih, w_hh, b_ih, b_hh = ws
    ys, h = gru(x, w_ih, w_hh, b_ih, b_hh)
    want = torch.autograd.grad(ys.square().sum() + h.sum(), ws)
    ys2, h2 = k3.gru_recurrence(x @ w_ih + b_ih, w_hh, b_hh, torch.zeros(2, H))
    got = torch.autograd.grad(ys2.square().sum() + h2.sum(), ws)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


@pytest.mark.slow
def test_gru_backward_plain_matches_jax_kernel():
    """Against the JAX Pallas backward (``_backward_pallas``, K9) itself, in
    interpret mode."""
    from voiceactivityprojection_tpu.ops.gru_pallas import _backward_pallas

    p = _inputs(2, 16, 128, seed=5)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    ys, _ = _scan_recurrence(j["x_proj"], j["w_hh"], j["b_hh"], j["h0"])
    want = [np.asarray(g) for g in _backward_pallas(
        j["x_proj"], j["w_hh"], j["b_hh"], j["h0"], ys, j["cy"], j["ch"])]
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = k3.gru_backward(t["x_proj"], t["w_hh"], t["b_hh"], t["h0"],
                          torch.from_numpy(np.array(ys)), t["cy"], t["ch"])
    _close(got, want)


def test_gru_backward_wrapper_checks_and_refuses_other_devices():
    meta = torch.device("meta")
    e = lambda *s: torch.empty(*s, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        k3.gru_backward(e(1, 4, 96), e(32, 96), e(96), e(1, 32), e(1, 4, 32), e(1, 4, 32))
    with pytest.raises(ValueError, match="hidden"):
        k3.gru_backward(e(1, 4, 90), e(30, 90), e(90), e(1, 30), e(1, 4, 30), e(1, 4, 30))


@pytest.mark.parametrize("rows,hidden,want", [(64000, 256, 6), (4096, 256, 6), (40, 256, 2), (99, 32, 4)])
def test_weight_reduction_splits(rows, hidden, want):
    """K9's dW_hh / db_hh reduction cuts the R*T rows into slices: enough
    (tile, slice) blocks for two per SM of an H100, at least 32 rows each."""
    assert k3.weight_splits(rows, hidden) == want
