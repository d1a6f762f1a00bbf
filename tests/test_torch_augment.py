"""PyTorch port, the training augmentation on the CPU against the JAX
package: ``stft`` / ``istft`` and the phase-vocoder pitch shift
(``ops/pitchshift.py``), the channel flip, the VAD mask, noise, the
frequency mask, ``augment_on_device`` at every composite choice and
``Augmentation.plan``, on the same numpy inputs with the JAX draws
recomputed here from the same keys and handed to the port."""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.scipy.signal import istft as jistft
from jax.scipy.signal import stft as jstft

from voiceactivityprojection_tpu.ops import pitchshift as jps
from voiceactivityprojection_tpu.train import augment as jaug
from voiceactivityprojection_tpu_torch.ops import pitchshift as tps
from voiceactivityprojection_tpu_torch.train import augment as taug

pytestmark = pytest.mark.train

torch.set_num_threads(2)

SR = 16_000
N4 = 4 * SR  # the 4 s windows of the training tests
# the pitch shift against JAX, absolute, on 0.1-rms noise (peaks about
# 0.35). JAX sums the phase over ~500 frames in float32 up to ~1e5 rad,
# where a float32 step is ~0.01 rad: its output is 1.5e-3 to 2.2e-3 from a
# float64 computation of its own algorithm, the port's (float64 phases)
# within 1e-6 (test_pitch_shift_sides_match_float64); port and JAX 1.5e-3
# to 2.2e-3 apart
PITCH_TOL = 5e-3
PITCH_F64_TOL = 2e-6  # the port against the float64 computation (9.7e-7 measured)
FMASK_TOL = 1e-5  # the STFT pair alone: 2.4e-7 measured


def _x(rows, n=N4, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((rows, n))).astype(np.float32)


def _batch(B=2, n=N4, seed=0):
    rng = np.random.default_rng(seed)
    frames = n // 320 + 100
    return {
        "waveform": (0.1 * rng.standard_normal((B, 2, n))).astype(np.float32),
        "vad": (rng.random((B, frames, 2)) < 0.5).astype(np.float32),
    }


# ----------------------------------------------------------------- STFT ---
@pytest.mark.parametrize("nperseg,hop", [(512, 128), (400, 200)])
@pytest.mark.parametrize("n", [N4, 12_345])
def test_stft_istft_match_jax(nperseg, hop, n):
    x = _x(3, n, seed=1)
    _, _, zj = jstft(jnp.asarray(x), nperseg=nperseg, noverlap=nperseg - hop)
    zt = tps.stft(torch.from_numpy(x), nperseg, nperseg - hop)
    assert tuple(zt.shape) == zj.shape and zt.dtype == torch.complex64
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)
    _, yj = jistft(zj, nperseg=nperseg, noverlap=nperseg - hop)
    yt = tps.istft(torch.from_numpy(np.array(zj)), nperseg, nperseg - hop)
    assert tuple(yt.shape) == yj.shape
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    # the pair reconstructs its input
    np.testing.assert_allclose(yt.numpy()[:, :n], x, atol=1e-5)


def test_stretch_steps_and_positions_match_jax():
    for steps in (1, 2, -1, -2):
        rate = 2.0 ** (-steps / 12)
        t = np.asarray(jnp.arange(0, 501, rate))
        idx, alpha = tps.stretch_steps(501, rate)
        np.testing.assert_array_equal(idx.numpy(), t.astype(np.int32))
        np.testing.assert_array_equal(alpha.numpy(), np.asarray(jnp.asarray(t) % 1.0))
        want = np.asarray(jax.jit(lambda: jnp.arange(N4) / rate)())
        np.testing.assert_array_equal(tps.read_positions(N4, rate).numpy(), want)


# ---------------------------------------------------------- pitch shift ---
@pytest.mark.parametrize("steps", [1, 2, -1, -2])
def test_pitch_shift_matches_jax(steps):
    x = _x(4)
    want = np.asarray(jps.pitch_shift_semitones(jnp.asarray(x), steps))
    got = tps.pitch_shift_semitones(torch.from_numpy(x), steps)
    assert tuple(got.shape) == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=PITCH_TOL)
    t = torch.from_numpy(x)
    assert tps.pitch_shift_semitones(t, 0) is t


def _pitch_f64(x, steps):
    """The same algorithm in float64 throughout (numpy FFT, a plain loop
    overlap-add), but for the resample positions, float32 as both sides
    compute them: the yardstick both sides are held against."""
    rate = 2.0 ** (-steps / 12)
    N, H = 512, 128
    win = np.sin(np.pi * np.arange(N) / N) ** 2
    xp = np.pad(x.astype(np.float64), [(0, 0), (N // 2, N // 2)])
    xp = np.pad(xp, [(0, 0), (0, (-(xp.shape[-1] - N) % H) % N)])
    starts = np.arange(0, xp.shape[-1] - N + 1, H)
    z = np.fft.rfft(xp[:, starts[:, None] + np.arange(N)] * win, axis=-1).transpose(0, 2, 1) / win.sum()
    F, T = z.shape[-2:]
    pa = np.linspace(0, math.pi * H, F)[:, None]
    ts = np.arange(0, T, rate, dtype=np.float32).astype(np.float64)
    i0, al = ts.astype(np.int64), ts % 1.0
    zp = np.pad(z, [(0, 0), (0, 0), (0, 2)])
    s0, s1 = zp[..., i0], zp[..., i0 + 1]
    ph = np.angle(s1) - np.angle(s0) - pa
    ph = ph - 2 * math.pi * np.round(ph / (2 * math.pi)) + pa
    acc = np.cumsum(np.concatenate([np.angle(z[..., :1]), ph[..., :-1]], -1), -1)
    zs = (al * np.abs(s1) + (1 - al) * np.abs(s0)) * np.exp(1j * acc)
    frames = np.fft.irfft(zs, n=N, axis=-2) * win.sum() * win[:, None]
    nf = frames.shape[-1]
    y = np.zeros((x.shape[0], H * (nf - 1) + N))
    norm = np.zeros(H * (nf - 1) + N)
    for j in range(nf):
        y[:, j * H: j * H + N] += frames[..., j]
        norm[j * H: j * H + N] += win * win
    y = y[:, N // 2: -(N // 2)] / np.where(norm[N // 2: -(N // 2)] > 1e-10, norm[N // 2: -(N // 2)], 1.0)
    inv = np.float32(1.0) / np.float32(rate)
    pos = np.minimum((np.arange(x.shape[-1], dtype=np.float32) * inv).astype(np.float64), y.shape[-1] - 1.0)
    base = np.floor(pos)
    k = np.arange(-7, 9)
    idx = np.clip(base[:, None].astype(np.int64) + k, 0, y.shape[-1] - 1)
    d = k[None] - (pos - base)[:, None]
    w = np.sinc(d) * np.where(np.abs(d) <= 8, 0.5 * (1 + np.cos(math.pi * d / 8)), 0.0)
    w /= w.sum(-1, keepdims=True)
    return (y[:, idx] * w).sum(-1)


@pytest.mark.parametrize("steps", [1, 2, -1, -2])
def test_pitch_shift_sides_match_float64(steps):
    """Each side against the float64 computation of the algorithm: the port
    within PITCH_F64_TOL, JAX within PITCH_TOL and at least a hundred times
    farther (measured: port 7.2e-7 to 9.7e-7, JAX 1.5e-3 to 2.2e-3)."""
    x = _x(4)
    ref = _pitch_f64(x, steps)
    jerr = float(np.abs(np.asarray(jps.pitch_shift_semitones(jnp.asarray(x), steps)) - ref).max())
    terr = float(np.abs(tps.pitch_shift_semitones(torch.from_numpy(x), steps).numpy() - ref).max())
    assert terr <= PITCH_F64_TOL and jerr <= PITCH_TOL, (terr, jerr)
    assert 100 * terr <= jerr, (terr, jerr)


def test_pitch_shift_keeps_length_and_bfloat16():
    x = torch.from_numpy(_x(2, 8000))
    y = tps.pitch_shift_semitones(x.to(torch.bfloat16).reshape(1, 2, -1), 2)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 2, 8000)
    assert torch.isfinite(y.float()).all()


# ------------------------------------------------------ the pure halves ---
def _flip_mask_draws(key, B, p):
    return np.asarray(jax.random.bernoulli(key, p, (B,)))


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_flip_channels_exact(p):
    b = _batch(B=4)
    key = jax.random.key(7)
    want = jaug.flip_channels(jax.tree.map(jnp.asarray, b), key, p)
    flip = torch.from_numpy(_flip_mask_draws(key, 4, p))
    got = taug.flip_channels({k: torch.from_numpy(v) for k, v in b.items()}, flip)
    for k in ("waveform", "vad"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("n", [N4, 8000 + 123])
def test_mask_vad_channels_exact(n):
    b = _batch(B=4, n=n, seed=3)
    key = jax.random.key(11)
    want = jaug.mask_vad_channels(jax.tree.map(jnp.asarray, b), key, 0.6)
    apply = torch.from_numpy(_flip_mask_draws(key, 4, 0.6))
    got = taug.mask_vad_channels({k: torch.from_numpy(v) for k, v in b.items()}, apply)
    np.testing.assert_array_equal(got["waveform"].numpy(), np.asarray(want["waveform"]))
    np.testing.assert_array_equal(got["vad"].numpy(), b["vad"])


def test_add_gaussian_noise_exact_given_the_noise():
    """Given JAX's noise, equal to XLA's fused ``w + 0.01 * noise`` (one
    rounding) bit for bit; against ``add_gaussian_noise`` itself, whose
    fusion also folds the constant into the draw's scale, within one float32
    step of the output."""
    x = _x(3)
    key = jax.random.key(5)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    got = taug.add_gaussian_noise(torch.from_numpy(x), torch.from_numpy(noise.copy()), 0.01).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(lambda w, n: w + 0.01 * n)(x, noise)))
    want = np.asarray(jaug.add_gaussian_noise(jnp.asarray(x), key, 0.01))
    np.testing.assert_allclose(got, want, atol=float(np.spacing(np.float32(np.abs(want).max()))), rtol=0)


def _band(key, n_fft=400, max_bins=40):
    k1, k2 = jax.random.split(key)
    width = int(jax.random.randint(k1, (), 0, max_bins + 1))
    start = int(jax.random.randint(k2, (), 0, max(n_fft // 2 + 1 - width, 1)))
    return width, start


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frequency_mask_matches_jax(seed):
    x = _x(3, seed=seed).reshape(3, 1, -1)
    key = jax.random.key(seed)
    want = np.asarray(jaug.frequency_mask(jnp.asarray(x), key))
    width, start = _band(key)
    got = taug.frequency_mask(torch.from_numpy(x), width, start)
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FMASK_TOL)


def test_draws_are_a_function_of_the_generator():
    g = lambda: torch.Generator().manual_seed(3)
    kw = dict(do_flip=True, flip_prob=0.5, do_mask=True, mask_prob=0.4, noise_device=torch.device("cpu"))
    a, b = (taug.draw_augment(g(), 3, (4, 2, 1000), **kw) for _ in range(2))
    assert torch.equal(a.flip, b.flip) and torch.equal(a.mask, b.mask) and a.band == b.band
    assert torch.equal(a.noise, b.noise) and tuple(a.noise.shape) == (4, 2, 1000)
    none = taug.draw_augment(g(), 0, (4, 2, 1000), **dict(kw, do_flip=False, do_mask=False))
    assert none == taug.AugmentDraws()
    width, start = a.band
    assert 0 <= width <= 40 and 0 <= start < max(201 - width, 1)


# ------------------------------------------------ composite, and plan ---
AUG_KW = dict(noise_amplitude=0.01, sample_rate=SR, frame_hz=50)
PITCH_STEPS = (0, 1, 2, -1, -2)


def _jax_augment(do_flip, do_mask, pitch_steps):
    return jax.jit(lambda batch, key, choice: jaug.augment_on_device(
        batch, key, choice, do_flip=do_flip, flip_prob=0.5, do_mask=do_mask, mask_prob=0.5,
        pitch_steps=pitch_steps, **AUG_KW))


@pytest.fixture(scope="module")
def composite():
    return _batch(B=2, seed=9), _jax_augment(True, True, PITCH_STEPS), _jax_augment(False, False, PITCH_STEPS)


@pytest.mark.parametrize("pitch", range(5))
@pytest.mark.parametrize("effect", range(4))
def test_augment_on_device_matches_jax(composite, effect, pitch):
    """Every composite choice with the flip and the VAD mask on, the JAX
    draws (flip k1, mask k2, noise k3, band k4 of ``split(key, 4)``) handed
    to the port: without pitch within the frequency mask's bar (exact with
    neither mask nor noise, one float32 step with noise alone), with it the
    pitch shift's. With pitch the JAX side runs in two calls, flip and mask,
    then the rest with the same key, its silences made +0 in between (see
    ``test_pitch_shift_of_negative_zero_silence``)."""
    b, jfn, jrest = composite
    choice = effect + 4 * pitch
    # the first key from 100 + choice on whose draws mask a sample
    key = next(k for k in (jax.random.key(100 + choice + 1000 * i) for i in range(50))
               if _flip_mask_draws(jax.random.split(k, 4)[1], 2, 0.5).any())
    jb = jax.tree.map(jnp.asarray, b)
    if pitch:
        masked = dict(jfn(jb, key, jnp.int32(0)))
        masked["waveform"] = masked["waveform"] + 0.0
        want = jrest(masked, key, jnp.int32(choice))
    else:
        want = jfn(jb, key, jnp.int32(choice))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = taug.AugmentDraws(
        flip=torch.from_numpy(_flip_mask_draws(k1, 2, 0.5)),
        mask=torch.from_numpy(_flip_mask_draws(k2, 2, 0.5)),
        band=_band(k4) if effect in (2, 3) else None,
        noise=torch.from_numpy(np.asarray(jax.random.normal(k3, b["waveform"].shape))) if effect in (1, 3) else None,
    )
    got = taug.augment_on_device({k: torch.from_numpy(v) for k, v in b.items()}, draws, choice,
                                 pitch_steps=PITCH_STEPS, **AUG_KW)
    np.testing.assert_array_equal(got["vad"].numpy(), np.asarray(want["vad"]))
    # noise alone: one float32 step of the output (see the noise test)
    tol = PITCH_TOL if pitch else (FMASK_TOL if effect in (2, 3) else (6e-8 if effect else 0.0))
    np.testing.assert_allclose(got["waveform"].numpy(), np.asarray(want["waveform"]), atol=tol, rtol=0)


def test_pitch_shift_of_negative_zero_silence():
    """A divergence, recorded: the VAD mask silences with ``0 * x``, -0 where
    x < 0. JAX's FFT gives the DC bin of an all -0 frame as -0 (phase pi),
    and the phase carried past the silence moves JAX's output by ~0.06; the
    port's FFT gives +0 there, so its output does not depend on the sign of
    the silence, and it is JAX's for +0 silence within the pitch bar."""
    rng = np.random.default_rng(9)
    w = (0.1 * rng.standard_normal((4, N4))).astype(np.float32)
    act = np.repeat(rng.random((4, N4 // 320)) < 0.5, 320, axis=-1)
    wm = np.where(act, w, np.float32(0.0) * w)
    assert np.signbit(wm[wm == 0]).any()
    j_neg = np.asarray(jps.pitch_shift_semitones(jnp.asarray(wm), 2))
    j_pos = np.asarray(jps.pitch_shift_semitones(jnp.asarray(wm + np.float32(0.0)), 2))
    assert np.abs(j_neg - j_pos).max() > 10 * PITCH_TOL
    t_neg = tps.pitch_shift_semitones(torch.from_numpy(wm), 2)
    t_pos = tps.pitch_shift_semitones(torch.from_numpy(wm + np.float32(0.0)), 2)
    assert torch.equal(t_neg, t_pos)
    np.testing.assert_allclose(t_neg.numpy(), j_pos, atol=PITCH_TOL)


@pytest.mark.parametrize("mode", ["vocoder", "resample"])
@pytest.mark.parametrize("probability", [0.5, 1.0])
def test_plan_equals_jax_over_1000_draws(mode, probability):
    ja = jaug.Augmentation(seed=4, pitch_mode=mode, probability=probability)
    ta = taug.Augmentation(seed=4, pitch_mode=mode, probability=probability)
    assert ta.pitch_steps == ja.pitch_steps
    plans = [ta.plan() for _ in range(1000)]
    assert plans == [ja.plan() for _ in range(1000)]
    assert len({p for p in plans}) > 5


def test_psola_raises_naming_the_queue():
    """The psola mode, which raised until ``ops/prosody.py`` was ported, now
    builds and shifts as JAX's does (tests/test_torch_prosody.py holds it
    at the same bytes on voiced input); an unknown mode still raises."""
    ta, ja = taug.Augmentation(pitch_mode="psola"), jaug.Augmentation(pitch_mode="psola")
    w = np.zeros((1, 2, 1600), np.float32)
    np.testing.assert_array_equal(ta.apply_pitch_host(w, 1.0), ja.apply_pitch_host(w, 1.0))
    np.testing.assert_array_equal(taug.psola_pitch_shift(np.zeros((1, 100), np.float32), 1.0),
                                  jaug.psola_pitch_shift(np.zeros((1, 100), np.float32), 1.0))
    with pytest.raises(ValueError, match="pitch_mode"):
        taug.Augmentation(pitch_mode="other")


def test_naive_pitch_shift_matches_jax():
    x = _x(2, 16000).reshape(1, 2, -1)
    for semis in (2.0, -1.0):
        np.testing.assert_array_equal(taug.naive_pitch_shift(x, semis), jaug.naive_pitch_shift(x, semis))


def test_augmentation_call_applies_the_plan():
    """``Augmentation.__call__`` outside the step: with probability 1 every
    call changes the waveform and keeps its shape."""
    b = _batch(B=2, n=8000)
    aug = taug.Augmentation(probability=1.0, seed=0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(6):
        out = aug({k: torch.from_numpy(v) for k, v in b.items()}, gen)
        assert tuple(out["waveform"].shape) == b["waveform"].shape
        assert not np.array_equal(out["waveform"].numpy(), b["waveform"])
