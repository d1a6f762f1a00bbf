"""PyTorch port, the prosody DSP on the host (``ops/prosody.py``) and the
TD-PSOLA pitch augmentation, against the JAX package on the same numpy
inputs: a voiced harmonic tone whose F0 moves, noise, a tone pair of two
loudnesses and an input shorter than one analysis frame.

Both packages run the same numpy code, so every output is held at the same
bytes (atol 0). The resampler (``low_pass_filter_resample``,
``duration_avg``) is the repo's native library where it is built, else
scipy, in both packages alike: the bytes agree either way. The property
checks of the JAX package's tests/test_prosody.py run on the port as cases
of one parametrised test."""

import numpy as np
import pytest

from voiceactivityprojection_tpu.ops import prosody as jpros
from voiceactivityprojection_tpu.train import augment as jaug
from voiceactivityprojection_tpu_torch.ops import prosody as tpros
from voiceactivityprojection_tpu_torch.train import augment as taug

from _torch_native import same_native_backend

pytestmark = pytest.mark.functional

SR = 16_000


@pytest.fixture(autouse=True)
def one_audio_backend(monkeypatch):
    """The resampler at the same bytes needs both packages on one backend."""
    same_native_backend(monkeypatch)


def tone(freq, dur=1.0, amp=0.3):
    t = np.arange(int(dur * SR)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def sweep(f0, f1, dur=1.0, amp=0.3):
    t = np.arange(int(dur * SR)) / SR
    return (amp * np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * dur)))).astype(np.float32)


def harmonic(f0=140.0, f1=210.0, dur=0.8, seed=0):
    """Five harmonics of an F0 gliding from f0 to f1, with a little noise."""
    t = np.arange(int(dur * SR)) / SR
    phase = 2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * dur))
    x = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
    x = x * np.hanning(len(t)) ** 0.25
    return (x + 0.003 * np.random.default_rng(seed).standard_normal(len(t))).astype(np.float32)


SIGNALS = {
    "harmonic": harmonic(),
    "noise": (0.1 * np.random.default_rng(1).standard_normal(6000)).astype(np.float32),
    "two_levels": np.concatenate([tone(150, 0.3, amp=0.05), tone(150, 0.3, amp=0.4)]),
    "short": (0.1 * np.random.default_rng(2).standard_normal(300)).astype(np.float32),
}
SEGMENTS = [(0.05, 0.2), (0.25, 0.55)]

CASES = {
    "frame_rms": lambda m, x: m.frame_rms(x),
    "frame_signal": lambda m, x: m.frame_signal(x, 400, 160),
    "pitch_track": lambda m, x: m.pitch_track(x),
    "pitch_track_25ms": lambda m, x: m.pitch_track(x, frame_time=0.025),
    "pitch_marks": lambda m, x: np.asarray(m._pitch_marks(x, *m.pitch_track(x, frame_time=0.025), SR, 160)),
    "psola": lambda m, x: m._psola(x, *m.pitch_track(x, frame_time=0.025),
                                   1.2 * m.pitch_track(x, frame_time=0.025)[0]),
    "flatten_pitch": lambda m, x: m.flatten_pitch(x),
    "flatten_pitch_to_120": lambda m, x: m.flatten_pitch(x, target_f0=120.0),
    "shift_pitch": lambda m, x: m.shift_pitch(x, 0.9),
    "flatten_intensity": lambda m, x: m.flatten_intensity(x),
    "low_pass": lambda m, x: m.low_pass_filter_resample(x, 400),
    "duration_avg": lambda m, x: m.duration_avg(x, SEGMENTS if len(x) > SR // 2 else []),
    "time_scale_psola": lambda m, x: m.time_scale_psola(x, 1.3),
    "duration_words_psola": lambda m, x: m.duration_words_psola(x, SEGMENTS if len(x) > SR // 2 else []),
    "f0_statistics": lambda m, x: np.asarray(m.f0_statistics(m.pitch_track(x)[0])),
}


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    elif isinstance(a, list):
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("signal", sorted(SIGNALS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_prosody_function_matches_jax(case, signal):
    x = SIGNALS[signal]
    _same(CASES[case](tpros, x.copy()), CASES[case](jpros, x.copy()))


@pytest.mark.parametrize("cls, kw", [("FlatPitch", {}), ("FlatPitch", {"target_f0": 150.0}),
                                     ("ShiftPitch", {"factor": 1.1}), ("FlatIntensity", {}),
                                     ("LowPass", {"cutoff_freq": 400})])
def test_batch_transforms_match_jax(cls, kw):
    rng = np.random.default_rng(3)
    batch = np.stack([np.stack([harmonic(seed=1), 0.05 * rng.standard_normal(len(harmonic())).astype(np.float32)]),
                      np.stack([harmonic(120, 90, seed=2), harmonic(200, 160, seed=3)])])
    _same(getattr(tpros, cls)(**kw)(batch), getattr(jpros, cls)(**kw)(batch))


@pytest.mark.parametrize("semitones", [1.0, -2.0])
def test_psola_pitch_shift_matches_jax(semitones):
    w = np.stack([np.stack([harmonic(seed=4), harmonic(180, 120, seed=5)])])
    got = taug.psola_pitch_shift(w, semitones)
    want = jaug.psola_pitch_shift(w, semitones)
    assert got.shape == w.shape
    _same(got, want)


def test_augmentation_psola_plan_and_output_match_jax():
    """``Augmentation(pitch_mode="psola")``: the plan draws equal JAX's over
    200 draws at one seed, and each host pitch branch's output equals JAX's."""
    t, j = taug.Augmentation(seed=7, pitch_mode="psola"), jaug.Augmentation(seed=7, pitch_mode="psola")
    plans = [t.plan() for _ in range(200)]
    assert plans == [j.plan() for _ in range(200)]
    assert any(s is not None for s, _ in plans) and all(c < 4 for _, c in plans)
    w = np.stack([np.stack([harmonic(seed=6), harmonic(100, 150, seed=7)])])
    for semis in sorted({s for s, _ in plans if s is not None}):
        _same(t.apply_pitch_host(w, semis), j.apply_pitch_host(w, semis))


def _voiced_mean_std(x):
    f0, v = tpros.pitch_track(x)
    assert v.any()
    return f0[v].mean(), f0[v].std()


def _pure_tones():
    for f in (100, 150, 220, 330):
        mean, std = _voiced_mean_std(tone(f))
        assert abs(mean - f) < 3.0 and std < 2.0, (f, mean, std)


def _noise_unvoiced():
    x = (0.1 * np.random.default_rng(0).normal(size=SR)).astype(np.float32)
    assert tpros.pitch_track(x)[1].mean() < 0.4


def _flat_reduces_variation():
    x = sweep(120, 220)
    mean_before, std_before = _voiced_mean_std(x)
    mean_after, std_after = _voiced_mean_std(tpros.flatten_pitch(x))
    assert std_before > 15 and std_after < 0.4 * std_before and abs(mean_after - mean_before) < 30


def _shift_moves_mean():
    x = tone(150)
    assert _voiced_mean_std(tpros.shift_pitch(x, 1.2))[0] > 160
    assert _voiced_mean_std(tpros.shift_pitch(x, 0.8))[0] < 140


def _flat_intensity():
    x = np.concatenate([tone(150, 0.5, amp=0.05), tone(150, 0.5, amp=0.4)])
    before, after = tpros.frame_rms(x), tpros.frame_rms(tpros.flatten_intensity(x))
    active = before > 1e-3
    cv = lambda r: r[active].std() / r[active].mean()
    assert cv(after) < 0.3 * cv(before)


def _low_pass():
    x = tone(200) + tone(3000)
    y = tpros.low_pass_filter_resample(x, cutoff_freq=400)
    spec, freqs = np.abs(np.fft.rfft(y)), np.fft.rfftfreq(len(y), 1 / SR)
    assert len(y) == len(x) and spec[freqs > 1000].max() < 0.01 * spec[(freqs > 150) & (freqs < 250)].max()


def _time_scale_keeps_pitch():
    x = tone(180, 0.6)
    for factor in (1.5, 0.7):
        y = tpros.time_scale_psola(x, factor)
        assert abs(len(y) - int(round(len(x) * factor))) <= 2
        assert abs(_voiced_mean_std(y)[0] - 180) < 6.0


def _words_equalised():
    x = np.concatenate([tone(150, 0.2), tone(150, 0.1) * 0, tone(150, 0.6)])
    y, segs = tpros.duration_words_psola(x, [(0.0, 0.2), (0.3, 0.9)])
    assert all(abs(e - s - 0.4) < 0.02 for s, e in segs) and abs(_voiced_mean_std(y)[0] - 150) < 6.0


def _psola_augmentation_keeps_tempo():
    w = tone(150)[None, None].repeat(2, axis=1)
    y = taug.psola_pitch_shift(w, 2.0)
    assert y.shape == w.shape
    assert _voiced_mean_std(y[0, 0])[0] > 150 * 2 ** (1 / 12)


PROPERTIES = {"pure_tones": _pure_tones, "noise_unvoiced": _noise_unvoiced,
              "flat_reduces_variation": _flat_reduces_variation, "shift_moves_mean": _shift_moves_mean,
              "flat_intensity": _flat_intensity, "low_pass": _low_pass,
              "time_scale_keeps_pitch": _time_scale_keeps_pitch, "words_equalised": _words_equalised,
              "psola_augmentation_keeps_tempo": _psola_augmentation_keeps_tempo}


@pytest.mark.parametrize("prop", sorted(PROPERTIES))
def test_prosody_properties(prop):
    PROPERTIES[prop]()
