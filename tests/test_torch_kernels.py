"""PyTorch port, the three kernel modules.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
those plain versions against the JAX package's plain references on the
same numpy inputs, and check that the wrappers refuse what the kernels do
not take instead of falling back. The interpret-mode comparisons against
the JAX Pallas kernels are ``slow``, as the JAX package's own kernel tests
are. The CUDA kernels themselves are held against the plain versions on
the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from voiceactivityprojection_tpu.models.encoder import _downsample, init_encoder
from voiceactivityprojection_tpu.ops import flash_alibi as jflash
from voiceactivityprojection_tpu.ops.attention import alibi_slopes as jalibi
from voiceactivityprojection_tpu.ops.conv_stack_fused import _reference_stack
from voiceactivityprojection_tpu.ops.gru import gru as jgru
from voiceactivityprojection_tpu_torch.ops import _build
from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
from voiceactivityprojection_tpu_torch.ops import flash_alibi as k4
from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes

pytestmark = pytest.mark.encoder

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def enc():
    init = jax.jit(init_encoder, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.key(0), 256))


def _conv_layers(enc):
    return [
        (_t(l["conv"]["w"]), _t(l["conv"]["b"]), _t(l["norm"]["w"]), _t(l["norm"]["b"]))
        for l in enc["gEncoder"]
    ]


def _gru_ds_inputs(H, T, B=2, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.2: (sc * rng.standard_normal(s)).astype(np.float32)
    return {
        "z": r(B, T, H, sc=1.0), "w_ih": r(H, 3 * H), "b_ih": r(3 * H),
        "w_hh": r(H, 3 * H), "b_hh": r(3 * H), "w_d": r(5, H, H, sc=0.1),
        "b_d": r(H), "ln_w": 1 + r(H), "ln_b": r(H),
    }


def _attn_inputs(B, H, T, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, Dh)).astype(np.float32) for _ in range(3)]


# ---------------------------------------------------------------- K1 --------
@pytest.mark.parametrize("n", [16000, 12345])
def test_conv_stack_plain_matches_jax(enc, n):
    x = (0.1 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)
    want = np.asarray(jax.jit(_reference_stack)(jax.tree.map(jnp.asarray, enc), jnp.asarray(x)))
    got = k1.fused_conv_stack(_conv_layers(enc), _t(x)).numpy()
    assert got.shape == want.shape == (2, n // 160, 256)
    np.testing.assert_allclose(got, want, atol=1e-4)


# ---------------------------------------------------------------- K2 --------
@pytest.mark.parametrize("T", [48, 33])
def test_gru_downsample_plain_matches_jax(T):
    H = 128
    p = _gru_ds_inputs(H, T)
    g = {k: jnp.asarray(p[k]) for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
    ys, _ = jgru(g, jnp.asarray(p["z"]), impl="scan")
    d = {"downsample": {"conv": {"w": jnp.asarray(p["w_d"]), "b": jnp.asarray(p["b_d"])},
                        "ln": {"w": jnp.asarray(p["ln_w"]), "b": jnp.asarray(p["ln_b"])}}}
    want = np.asarray(_downsample(d, ys))

    x_proj = _t(p["z"]) @ _t(p["w_ih"]) + _t(p["b_ih"])
    got = k2.gru_downsample_fused(
        x_proj, _t(p["w_hh"]), _t(p["b_hh"]), torch.zeros(2, H),
        _t(p["w_d"]), _t(p["b_d"]), _t(p["ln_w"]), _t(p["ln_b"]),
    ).numpy()
    assert got.shape == want.shape == (2, (T + 1) // 2, H)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.slow
def test_gru_downsample_plain_matches_jax_kernel():
    """Against the JAX Pallas kernel itself, in interpret mode."""
    from voiceactivityprojection_tpu.ops.gru_pallas import gru_downsample_fused

    H, T = 128, 48
    p = _gru_ds_inputs(H, T, seed=1)
    x_proj = p["z"] @ p["w_ih"] + p["b_ih"]
    h0 = np.zeros((2, H), np.float32)
    args = [x_proj, p["w_hh"], p["b_hh"], h0, p["w_d"], p["b_d"], p["ln_w"], p["ln_b"]]
    want = np.asarray(gru_downsample_fused(*map(jnp.asarray, args)))
    got = k2.gru_downsample_fused(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------- K4/K5 -----
def test_attention_plain_matches_jax():
    B, H, T, Dh = 2, 4, 200, 16
    q, k, v = _attn_inputs(B, H, T, Dh)
    scale = 1.0 / np.sqrt(H * Dh)
    want = np.asarray(jflash._dense_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jalibi(H), scale))
    got = k4.flash_alibi_attention(_t(q), _t(k), _t(v), alibi_slopes(H), scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.slow
def test_attention_plain_matches_jax_kernel():
    """Against the JAX Pallas kernel itself, in interpret mode."""
    B, H, T, Dh = 1, 4, 200, 16
    q, k, v = _attn_inputs(B, H, T, Dh, seed=1)
    want = np.asarray(jflash.flash_alibi_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jalibi(H), 0.125))
    got = k4.flash_alibi_attention(_t(q), _t(k), _t(v), alibi_slopes(H), 0.125).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


# ---------------------------------------------------------------- wrappers --
def test_plain_paths_do_not_count_launches(enc):
    before = (k1.fused_conv_stack.launches, k2.gru_downsample_fused.launches,
              k4.flash_alibi_attention.launches)
    k1.fused_conv_stack(_conv_layers(enc), torch.zeros(1, 1600))
    q = torch.zeros(1, 2, 8, 64)
    k4.flash_alibi_attention(q, q, q, alibi_slopes(2), 0.1)
    p = _gru_ds_inputs(32, 4, B=1)
    k2.gru_downsample_fused(
        torch.zeros(1, 4, 96), _t(p["w_hh"]), _t(p["b_hh"]), torch.zeros(1, 32),
        _t(p["w_d"]), _t(p["b_d"]), _t(p["ln_w"]), _t(p["ln_b"]),
    )
    after = (k1.fused_conv_stack.launches, k2.gru_downsample_fused.launches,
             k4.flash_alibi_attention.launches)
    assert after == before


def test_wrappers_refuse_other_devices(enc):
    meta = torch.device("meta")
    layers = [tuple(t.to(meta) for t in l) for l in _conv_layers(enc)]
    with pytest.raises(ValueError, match="device"):
        k1.fused_conv_stack(layers, torch.empty(1, 1600, device=meta))
    q = torch.empty(1, 2, 8, 64, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        k4.flash_alibi_attention(q, q, q, torch.empty(2, device=meta), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        k2.gru_downsample_fused(
            torch.empty(1, 4, 96, device=meta), torch.empty(32, 96, device=meta),
            torch.empty(96, device=meta), torch.empty(1, 32, device=meta),
            torch.empty(5, 32, 32, device=meta), *(torch.empty(32, device=meta),) * 3,
        )


def test_kernel_launch_refuses_cpu_tensors(enc):
    """The launch functions take CUDA tensors only: no silent CPU run."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.conv_cn_relu(torch.zeros(1, 1600), _conv_layers(enc)[0], 5, 3)


def test_wrappers_check_shapes():
    with pytest.raises(ValueError, match="share one"):
        k4.flash_alibi_attention(torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 9, 32),
                                 torch.zeros(1, 2, 8, 32), alibi_slopes(2), 0.1)
    with pytest.raises(ValueError, match="w_d"):
        k2.gru_downsample_fused(torch.zeros(1, 4, 96), torch.zeros(32, 96), torch.zeros(96),
                                torch.zeros(1, 32), torch.zeros(4, 32, 32),
                                *(torch.zeros(32),) * 3)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_alibi")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k1._lib()


def test_build_hash_follows_sources():
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for n, p in paths.items():
        assert p.parent == _build.BUILD_DIR and n in p.name
        assert (_build.CSRC_DIR / f"{n}.cu").is_file()
