"""PyTorch port, the host half of offline extraction: WAV loading and
resampling (native decoder and scipy), the VAD list and one-hot helpers,
the model-VAD morphology on torch tensors, and the command-line binding of
the configs, each against the JAX package on the same inputs (exact)."""

import argparse
import wave

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy.io import wavfile

from voiceactivityprojection_tpu import config as jconfig
from voiceactivityprojection_tpu.ops import audio as jaudio
from voiceactivityprojection_tpu.ops import vad as jvad
from voiceactivityprojection_tpu.utils import native as jnative
from voiceactivityprojection_tpu_torch import config as tconfig
from voiceactivityprojection_tpu_torch.ops import audio as taudio
from voiceactivityprojection_tpu_torch.ops import vad as tvad
from voiceactivityprojection_tpu_torch.utils import native as tnative

from _torch_native import same_native_backend

pytestmark = pytest.mark.functional


# ------------------------------------------------------------------ audio --
def _signal(channels, seconds, sr, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal((int(seconds * sr), channels))).clip(-1, 1)


def _write(path, kind, x, sr):
    if kind == "int16":
        wavfile.write(path, sr, (x * 32767).astype(np.int16))
    elif kind == "int32":
        wavfile.write(path, sr, (x * (2**31 - 1)).astype(np.int32))
    else:  # 24-bit PCM: the three low bytes of each little-endian int32
        pcm = (x * (2**23 - 1)).astype("<i4").tobytes()
        data = b"".join(pcm[i : i + 3] for i in range(0, len(pcm), 4))
        with wave.open(str(path), "wb") as f:
            f.setnchannels(x.shape[1])
            f.setsampwidth(3)
            f.setframerate(sr)
            f.writeframes(data)
    return str(path)


# (format, channels, seconds, sample rate, start_time, end_time)
FILES = [
    ("int16", 2, 1.7, 16000, None, None),
    ("int32", 2, 1.3, 16000, None, None),
    ("int24", 2, 1.1, 16000, None, None),
    ("int16", 1, 1.5, 22050, None, None),
    ("int24", 1, 1.2, 22050, 0.25, 0.9),
    ("int16", 2, 2.0, 16000, 0.5, 1.37),
]


@pytest.fixture(params=["native", "scipy"])
def decoder(request, monkeypatch):
    """Both packages on the native library, or both on scipy."""
    if request.param == "native":
        # builds the library once under the port's lock, on one backend in both packages
        if not same_native_backend(monkeypatch):
            pytest.skip("native/libvapaudio.so is not built here (no compiler)")
    else:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("kind, ch, seconds, sr, start, end", FILES)
def test_load_waveform_matches_jax(decoder, tmp_path, kind, ch, seconds, sr, start, end):
    path = _write(tmp_path / "a.wav", kind, _signal(ch, seconds, sr, seed=ch), sr)
    want, want_sr = jaudio.load_waveform(path, sample_rate=16000, start_time=start, end_time=end)
    used = {}
    got, got_sr = taudio.load_waveform(path, sample_rate=16000, start_time=start, end_time=end, backends=used)
    assert got_sr == want_sr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert used == {"decoder": decoder, "resampler": decoder if sr != 16000 else None}
    # the run CLI's silent second channel
    np.testing.assert_array_equal(taudio.mono_to_stereo(got[None]), jaudio.mono_to_stereo(want[None]))
    assert taudio.get_audio_info(path) == jaudio.get_audio_info(path)
    # the mono mix-down, and no resampling
    np.testing.assert_array_equal(taudio.load_waveform(path, sample_rate=None, mono=True)[0],
                                  jaudio.load_waveform(path, sample_rate=None, mono=True)[0])


@pytest.mark.parametrize("kind", ["int16", "int32", "int24"])
def test_native_decoder_equals_scipy(tmp_path, kind, monkeypatch):
    """The native decoder and the scipy branch read the same samples, bit
    for bit; the resamplers agree to float32 rounding."""
    if not tnative.available():
        pytest.skip("native/libvapaudio.so is not built here (no compiler)")
    path = _write(tmp_path / "a.wav", kind, _signal(2, 1.0, 22050, seed=7), 22050)
    native, _ = taudio.load_waveform(path, sample_rate=None, start_time=0.1, end_time=0.8)
    native_rs, _ = taudio.load_waveform(path)
    monkeypatch.setattr(tnative, "available", lambda: False)
    used = {}
    scipy_x, _ = taudio.load_waveform(path, sample_rate=None, start_time=0.1, end_time=0.8, backends=used)
    scipy_rs, _ = taudio.load_waveform(path)
    assert used == {"decoder": "scipy", "resampler": None}
    np.testing.assert_array_equal(native, scipy_x)
    assert native_rs.shape == scipy_rs.shape
    np.testing.assert_allclose(native_rs, scipy_rs, atol=1e-5)


def test_log_mel_matches_jax():
    x = _signal(2, 0.5, 16000, seed=3).T.astype(np.float32)
    np.testing.assert_allclose(taudio.log_mel_spectrogram(x), jaudio.log_mel_spectrogram(x), rtol=1e-6, atol=1e-6)


def test_native_helpers_match_jax(monkeypatch):
    if not same_native_backend(monkeypatch):
        pytest.skip("native/libvapaudio.so is not built here (no compiler)")
    raw = (np.random.default_rng(4).integers(-3000, 3000, size=2 * 513)).astype(np.int16).tobytes()
    np.testing.assert_array_equal(tnative.deinterleave_i16(raw, 2), jnative.deinterleave_i16(raw, 2))
    x = np.random.default_rng(5).integers(0, 3, size=400).astype(np.int32)
    for a, b in zip(tnative.rle_i32(x), jnative.rle_i32(x)):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------------- VAD --
def _runs(rng, T, p):
    """A binary track of random runs, so every run length occurs."""
    out, v = [], int(rng.random() < 0.5)
    while len(out) < T:
        out += [v] * int(rng.integers(1, 9))
        v = 1 - v if rng.random() < p else v
    return out[:T]


def _vad_batch(seed, B=3, T=257):
    rng = np.random.default_rng(seed)
    vad = np.array([[_runs(rng, T, 0.9) for _ in range(2)] for _ in range(B)], dtype=np.float32)
    vad = vad.transpose(0, 2, 1)  # (B, T, 2)
    vad[0, :1, 0], vad[0, 1:3, 0] = 0.0, 1.0  # a one-frame silence at the start
    vad[0, -1:, 1], vad[0, -3:-1, 1] = 1.0, 0.0  # a one-frame spike at the end
    return vad


@pytest.mark.parametrize("max_time", [0.0, 0.02, 0.1])
@pytest.mark.parametrize("seed", [0, 1])
def test_fill_silences_and_omit_spikes_match_jax(max_time, seed):
    vad = _vad_batch(seed)
    for tf, jf in ((tvad.vad_fill_silences, jvad.vad_fill_silences), (tvad.vad_omit_spikes, jvad.vad_omit_spikes)):
        got = tf(torch.from_numpy(vad), max_time, 50)
        want = np.asarray(jf(jnp.asarray(vad), max_time, 50))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    if max_time == 0.0:
        np.testing.assert_array_equal(tvad.vad_fill_silences(torch.from_numpy(vad), 0.0).numpy(), vad)


def test_fill_short_runs_at_both_edges():
    """An edge run counts its true length: a 1-frame silence at either end
    is filled at max 1 frame, a 2-frame one is not."""
    x = torch.tensor([[0, 1, 1, 0, 0, 1, 1, 0], [0, 0, 1, 1, 1, 1, 1, 0]], dtype=torch.float32)
    vad = x.T[None]  # (1, T, 2)
    got = tvad.vad_fill_silences(vad, 0.02, 50)[0].T
    assert got.tolist() == [[1, 1, 1, 0, 0, 1, 1, 1], [0, 0, 1, 1, 1, 1, 1, 1]]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jvad.vad_fill_silences(jnp.asarray(vad.numpy())))[0].T)


def test_dialog_states_match_jax():
    vad = _vad_batch(2)
    np.testing.assert_array_equal(tvad.get_dialog_states(torch.from_numpy(vad)).numpy(),
                                  np.asarray(jvad.get_dialog_states(jnp.asarray(vad))))
    np.testing.assert_array_equal(tvad.get_dialog_states_np(vad), jvad.get_dialog_states_np(vad))


def test_find_island_idx_len_matches_jax():
    for x in (np.array([]), np.array([3]), np.random.default_rng(0).integers(0, 3, 200)):
        for a, b in zip(tvad.find_island_idx_len(x), jvad.find_island_idx_len(x)):
            np.testing.assert_array_equal(a, b)


VAD_LIST = [[[0.0, 1.21], [1.5, 2.02], [2.05, 3.3], [5.1, 6.0]], [[0.9, 1.6], [3.0, 4.44], [4.5, 4.52]]]


def test_vad_lists_match_jax():
    for kw in ({"frame_hz": 50}, {"hop_time": 0.02, "channel_first": True}, {"frame_hz": 25}):
        np.testing.assert_array_equal(tvad.vad_list_to_onehot(VAD_LIST, 6.5, **kw),
                                      jvad.vad_list_to_onehot(VAD_LIST, 6.5, **kw))
    onehot = tvad.vad_list_to_onehot(VAD_LIST, 6.5, frame_hz=50)[None]
    batch = np.concatenate([onehot, _vad_batch(3, B=2, T=onehot.shape[1])])
    for thresh in (0.1, 0.0, 0.5):
        assert tvad.vad_onehot_to_vad_list(batch, 50, thresh) == jvad.vad_onehot_to_vad_list(batch, 50, thresh)
    for start, end in ((0.0, 6.5), (1.0, 3.1), (2.04, 4.5), (4.0, 4.51)):
        assert tvad.get_vad_list_subset(VAD_LIST, start, end) == jvad.get_vad_list_subset(VAD_LIST, start, end)
    w = np.ones((3, 1, 5), np.float32)
    np.testing.assert_array_equal(tvad.add_zero_channel(w), jvad.add_zero_channel(w))


@pytest.mark.parametrize("bins", [(60, 30, 10, 5), (7, 3), (400,)])
def test_activity_history_matches_jax(bins):
    vad = _vad_batch(4, B=1, T=300)[0]
    np.testing.assert_array_equal(tvad.get_activity_history(vad, bins), jvad.get_activity_history(vad, bins))
    with pytest.raises(ValueError):
        tvad.get_activity_history(vad, (3, 5))


# --------------------------------------------------------- argparse binding --
def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["VapConfig", "VapMonoConfig", "OptConfig"])
def test_argparse_flags_match_jax(name):
    t, j = getattr(tconfig, name), getattr(jconfig, name)
    assert t.PREFIX == j.PREFIX and "PREFIX" not in t.__dataclass_fields__
    assert _actions(t.add_argparse_args(argparse.ArgumentParser())) == \
        _actions(j.add_argparse_args(argparse.ArgumentParser()))
    assert t.args_to_conf(t.add_argparse_args(argparse.ArgumentParser()).parse_args([])) == t()


def test_args_to_conf_round_trips_a_tuple_and_a_bool():
    argv = ["--vap_bin_times", "0.2", "0.4", "--vap_freeze_encoder", "0", "--vap_dim", "32",
            "--vap_representation", "independent"]
    parser = tconfig.VapConfig.add_argparse_args(argparse.ArgumentParser())
    conf = tconfig.VapConfig.args_to_conf(parser.parse_args(argv))
    assert conf.bin_times == (0.2, 0.4) and conf.freeze_encoder is False and conf.dim == 32
    assert conf.head_dim == 4
    jparser = jconfig.VapConfig.add_argparse_args(argparse.ArgumentParser())
    jconf = jconfig.VapConfig.args_to_conf(jparser.parse_args(argv))
    assert {f: getattr(conf, f) for f in conf.__dataclass_fields__} == \
        {f: getattr(jconf, f) for f in jconf.__dataclass_fields__}
    opt = tconfig.OptConfig.args_to_conf(
        tconfig.OptConfig.add_argparse_args(argparse.ArgumentParser()).parse_args(
            ["--opt_betas", "0.8", "0.99", "--opt_early_stopping", "0"]))
    assert opt.betas == (0.8, 0.99) and opt.early_stopping is False
