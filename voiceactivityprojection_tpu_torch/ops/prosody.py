"""Prosody analysis and manipulation on the host (JAX: ops/prosody.py).

Plain numpy DSP, as in the JAX package, so that both give the same bytes
for the same input; nothing here runs on the card:

* ``pitch_track``: Boersma's (1993) autocorrelation F0 (praat's
  ``to_pitch`` defaults: a 3/fmin Hann window normalised by its own
  autocorrelation, candidate peaks with octave, jump and voicing costs, an
  unvoiced strength that rises in silence, a Viterbi path), 60-500 Hz;
* ``flatten_pitch`` / ``shift_pitch``: TD-PSOLA (cross-correlation-aligned
  glottal epochs, grains resampled to the target period, overlap-added at
  the target spacing, unvoiced spans passed through);
* ``flatten_intensity``: frame gains toward the mean active RMS;
* ``low_pass_filter_resample``: resample to 2 x cutoff and back;
* ``duration_avg`` (resampled segments), ``time_scale_psola`` and
  ``duration_words_psola`` (pitch-preserving duration changes);
* the ``_BatchTransform`` callables over (B, C, n) batches.

Resampling goes through ``ops/audio.resample`` (the native library where
it is built, else scipy), as JAX's goes through its own.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def frame_signal(x: np.ndarray, frame_len: int, hop: int) -> np.ndarray:
    if len(x) < frame_len:  # short input: one zero-padded frame, not a crash
        x = np.pad(x, (0, frame_len - len(x)))
    n = 1 + (len(x) - frame_len) // hop
    idx = np.arange(frame_len)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def frame_rms(x: np.ndarray, frame_len: int = 400, hop: int = 160) -> np.ndarray:
    f = frame_signal(np.asarray(x, dtype=np.float32), frame_len, hop)
    return np.sqrt((f ** 2).mean(-1) + 1e-12)


def pitch_track(
    x: np.ndarray,
    sample_rate: int = 16_000,
    hop_time: float = 0.01,
    fmin: float = 60.0,
    fmax: float = 500.0,
    voicing_threshold: float = 0.45,
    silence_threshold: float = 0.03,
    octave_cost: float = 0.01,
    octave_jump_cost: float = 0.35,
    voiced_unvoiced_cost: float = 0.14,
    n_candidates: int = 15,
    frame_time: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Boersma (1993) autocorrelation pitch — the algorithm behind praat's
    `to_pitch`, which the reference calls via parselmouth with floor 60 /
    ceiling 500 (vap/phrases/functional.py:22-24, 101-120). Defaults are
    praat's: window = 3 periods of fmin (50 ms), Hann-windowed frames with
    the estimator r(tau) = r_xw(tau) / r_w(tau) (autocorr of the windowed
    frame normalized by the window's own autocorr), per-frame candidate
    peaks scored R = r + OctaveCost*log2(f/fmin), an unvoiced candidate
    whose strength rises in silence (VoicingThreshold + max(0, 2 -
    localPeak/globalPeak / (SilenceThreshold/(1+VoicingThreshold)))), and
    a Viterbi path maximizing sum(R) - OctaveJumpCost*|log2 jumps| -
    VoicedUnvoicedCost transitions. localPeak is taken over the CENTRAL
    HALF of each frame (praat convention) — edge energy belongs to the
    neighboring frame whose center covers it, and measuring it here
    voiced an isolated silence-centered frame at 458 Hz on the reference
    example wav. Returns (f0, voiced) per hop frame; f0=0 when unvoiced.

    Anchored on the reference's own bounds (tests/test_functional.py:28-63
    via tests/test_prosody_reference_anchor.py): flat-pitch residual std
    0.82 Hz (praat bound 2.0), pure tones track to <0.01 Hz."""
    x = np.asarray(x, dtype=np.float32)
    hop = int(hop_time * sample_rate)
    frame_len = int(
        (frame_time if frame_time is not None else 3.0 / fmin) * sample_rate
    )
    lag_min = max(int(np.floor(sample_rate / fmax)), 2)
    lag_max = min(int(np.ceil(sample_rate / fmin)), frame_len // 2)
    global_peak = float(np.abs(x - x.mean()).max()) + 1e-12

    frames = frame_signal(x, frame_len, hop)
    T = len(frames)
    if T == 0:  # sub-frame input: no frames, no pitch (no crash)
        return np.zeros(0, np.float32), np.zeros(0, bool)
    frames0 = frames - frames.mean(-1, keepdims=True)
    q = max(frame_len // 4, 1)
    local_peak = np.abs(frames0[:, q:-q]).max(-1) + 1e-12
    win = np.hanning(frame_len).astype(np.float32)
    nfft = 1 << (2 * frame_len - 1).bit_length()
    spec = np.fft.rfft(frames0 * win[None, :], nfft)
    ac = np.fft.irfft(spec * np.conj(spec), nfft)[:, : lag_max + 2]
    ac0 = np.maximum(ac[:, 0], 1e-12)
    r = ac / ac0[:, None]
    wspec = np.fft.rfft(win, nfft)
    wac = np.fft.irfft(wspec * np.conj(wspec), nfft)[: lag_max + 2]
    r = r / np.maximum(wac / wac[0], 1e-3)[None, :]

    nc = n_candidates
    cf0 = np.zeros((T, nc))
    cR = np.full((T, nc), -np.inf)
    band = r[:, lag_min : lag_max + 1]
    interior = band[:, 1:-1]
    is_peak = (interior > band[:, :-2]) & (interior >= band[:, 2:])
    for i in range(T):
        pk = np.nonzero(is_peak[i])[0] + 1 + lag_min
        if pk.size == 0:
            continue
        # parabolic refinement of lag AND strength around each peak
        y0, y1, y2 = r[i, pk - 1], r[i, pk], r[i, pk + 1]
        den = y0 - 2 * y1 + y2
        d = np.where(
            np.abs(den) > 1e-12,
            0.5 * (y0 - y2) / np.where(np.abs(den) > 1e-12, den, 1.0),
            0.0,
        )
        d = np.clip(d, -1, 1)
        f0c = sample_rate / (pk + d)
        rref = y1 - 0.25 * (y0 - y2) * d
        keep = (f0c > fmin) & (f0c < fmax)
        f0c, rref = f0c[keep], rref[keep]
        R = rref + octave_cost * np.log2(np.maximum(f0c, 1e-9) / fmin)
        order = np.argsort(R)[::-1][:nc]
        k = len(order)
        cf0[i, :k] = f0c[order]
        cR[i, :k] = R[order]

    R_uv = voicing_threshold + np.maximum(
        0.0,
        2.0
        - (local_peak / global_peak)
        / (silence_threshold / (1.0 + voicing_threshold)),
    )
    NS = nc + 1
    score = np.full((T, NS), -np.inf)
    score[:, :nc] = cR
    score[:, nc] = R_uv
    logf = np.where(cf0 > 0, np.log2(np.maximum(cf0, 1e-9)), 0.0)
    total = score[0].copy()
    back = np.zeros((T, NS), dtype=np.int32)
    for i in range(1, T):
        tr = np.zeros((NS, NS))
        vp = cf0[i - 1] > 0
        vc = cf0[i] > 0
        dj = np.abs(logf[i - 1][:, None] - logf[i][None, :])
        tr[:nc, :nc] = np.where(
            vp[:, None] & vc[None, :], octave_jump_cost * dj, np.inf
        )
        tr[nc, :nc] = voiced_unvoiced_cost
        tr[:nc, nc] = voiced_unvoiced_cost
        tr[nc, nc] = 0.0
        cand_tot = total[:, None] - tr
        back[i] = np.argmax(cand_tot, axis=0)
        total = cand_tot[back[i], np.arange(NS)] + score[i]

    path = np.zeros(T, dtype=np.int32)
    path[-1] = int(np.argmax(total))
    for i in range(T - 2, -1, -1):
        path[i] = back[i + 1, path[i + 1]]

    sel = path < nc
    f0 = np.where(sel, cf0[np.arange(T), np.minimum(path, nc - 1)], 0.0)
    voiced = sel & (f0 > 0)
    f0 = np.where(voiced, f0, 0.0)
    return f0.astype(np.float32), voiced


def _pitch_marks(
    x: np.ndarray, f0: np.ndarray, voiced: np.ndarray, sample_rate: int, hop: int
) -> List[int]:
    """Sequential glottal-epoch placement (praat "To PointProcess
    (periodic, cc)" family): the first epoch of each voiced run aligns to
    the strongest peak of the lowpassed waveform; each subsequent epoch
    maximizes the normalized cross-correlation with the previous period.
    Phase-coherent epochs are what make PSOLA grains overlap-add cleanly —
    free-running marks (the previous implementation) gave adjacent grains
    random relative phase, which the measurement tracker read as ~2.2 Hz
    of F0 jitter on flattened speech (praat's own bound is 2.0)."""
    X = np.fft.rfft(x)
    fr = np.fft.rfftfreq(len(x), 1.0 / sample_rate)
    Y = X.copy()
    Y[fr > 900.0] = 0
    lp = np.fft.irfft(Y, len(x)).astype(np.float32)

    marks: List[int] = []
    t = 0
    n = len(x)
    default_period = int(sample_rate / 150)
    prev_voiced = False
    while t < n:
        fi = min(t // hop, len(f0) - 1)
        if voiced[fi] and f0[fi] > 0:
            period = int(round(sample_rate / f0[fi]))
            if not prev_voiced:  # voiced onset: anchor on the lowpass peak
                r = max(period // 2, 2)
                lo, hi = max(t - r, 0), min(t + r + 1, n)
                t_al = lo + int(np.argmax(lp[lo:hi]))
            else:  # continue: cc-align with the previous period
                t_prev = marks[-1]
                pred = t_prev + period
                r = max(period // 5, 2)
                h = max(period // 2, 4)
                ref = x[max(t_prev - h, 0) : t_prev + h]
                best, t_al = -np.inf, pred
                for s in range(max(pred - r, 0), min(pred + r + 1, n)):
                    seg = x[max(s - h, 0) : s + h]
                    L = min(len(ref), len(seg))
                    if L < 4:
                        continue
                    a, b = ref[:L], seg[:L]
                    sc = float(np.dot(a, b)) / (
                        np.linalg.norm(a) * np.linalg.norm(b) + 1e-9
                    )
                    if sc > best:
                        best, t_al = sc, s
            marks.append(t_al)
            t = t_al + max(period, 8)
            prev_voiced = True
        else:
            marks.append(t)
            t += default_period
            prev_voiced = False
    return marks


def _psola(
    x: np.ndarray,
    f0: np.ndarray,
    voiced: np.ndarray,
    target_f0: np.ndarray,
    sample_rate: int = 16_000,
    hop_time: float = 0.01,
) -> np.ndarray:
    """TD-PSOLA resynthesis toward target_f0 (same frame grid as f0).

    Three properties earned by measurement against the reference's own
    praat bounds (tests/test_prosody_reference_anchor.py):
    - grains are RESAMPLED so their internal period equals the target
      period before overlap-add — without this, grain-internal source
      periodicity beats against the new grain spacing and the tracker
      reads subharmonics (a 290->209 Hz flatten produced a 103 Hz cluster);
    - unvoiced spans PASS THROUGH unmodified (praat Manipulation leaves
      them untouched) via the window-sum crossfade `alpha` — regraining
      noise at a fixed rate planted spurious periodicity;
    - each synthesis pulse copies the NEAREST analysis epoch (not the
      nearest-below), halving the worst-case phase offset."""
    x = np.asarray(x, dtype=np.float32)
    hop = int(hop_time * sample_rate)
    marks = _pitch_marks(x, f0, voiced, sample_rate, hop)
    out = np.zeros_like(x)
    norm = np.zeros_like(x)
    n = len(x)

    t_out = 0.0
    mi = 0
    while t_out < n and mi < len(marks):
        while mi + 1 < len(marks) and marks[mi + 1] <= t_out:
            mi += 1
        m = marks[mi]
        if mi + 1 < len(marks) and abs(marks[mi + 1] - t_out) < abs(m - t_out):
            m = marks[mi + 1]
        fi = min(m // hop, len(f0) - 1)
        if voiced[fi] and f0[fi] > 0:
            src_period = int(round(sample_rate / f0[fi]))
            tgt = target_f0[min(int(t_out) // hop, len(target_f0) - 1)]
            tgt_period = src_period if tgt <= 0 else int(round(sample_rate / tgt))
            g0 = max(m - src_period, 0)
            g1 = min(m + src_period, n)
            grain = x[g0:g1]
            center = m - g0
            if tgt_period != src_period and len(grain) > 3:
                ratio = tgt_period / src_period
                new_len = max(int(round(len(grain) * ratio)), 4)
                grain = np.interp(
                    np.linspace(0, len(grain) - 1, new_len),
                    np.arange(len(grain)),
                    grain,
                ).astype(np.float32)
                center = int(round(center * ratio))
            win = np.hanning(len(grain)).astype(np.float32)
            o0 = int(t_out) - center
            lo = max(o0, 0)
            hi = min(o0 + len(grain), n)
            if hi > lo:
                gs = lo - o0
                out[lo:hi] += grain[gs : gs + hi - lo] * win[gs : gs + hi - lo]
                norm[lo:hi] += win[gs : gs + hi - lo]
            t_out += max(tgt_period, 8)
        else:
            t_out += max(int(sample_rate / 150), 8)

    alpha = np.clip(norm, 0.0, 1.0)
    y = alpha * (out / np.maximum(norm, 1e-8)) + (1.0 - alpha) * x
    return y.astype(np.float32)


def flatten_pitch(
    x: np.ndarray,
    target_f0: Optional[float] = None,
    sample_rate: int = 16_000,
    hop_time: float = 0.01,
) -> np.ndarray:
    """Resynthesize with constant F0 (mean voiced F0 unless given) —
    analogue of pitch_praat_flatten (functional.py). The ANALYSIS track
    uses a short 25 ms window: PSOLA mark placement needs local temporal
    resolution (the praat-default 3/fmin measurement window over-smooths
    onsets and misplaces grains — measured flat residual 4.6 Hz vs 1.9)."""
    f0, voiced = pitch_track(x, sample_rate, hop_time, frame_time=0.025)
    if not voiced.any():
        return np.asarray(x, dtype=np.float32)
    mean_f0 = float(target_f0 or f0[voiced].mean())
    tgt = np.where(voiced, mean_f0, 0.0)
    return _psola(x, f0, voiced, tgt, sample_rate, hop_time)


def shift_pitch(
    x: np.ndarray,
    factor: float,
    sample_rate: int = 16_000,
    hop_time: float = 0.01,
) -> np.ndarray:
    """Multiply the F0 contour by `factor`, preserving duration/formant-ish
    structure — analogue of pitch_praat_shift. Short analysis window for
    mark placement (see flatten_pitch)."""
    f0, voiced = pitch_track(x, sample_rate, hop_time, frame_time=0.025)
    tgt = np.where(voiced, f0 * factor, 0.0)
    return _psola(x, f0, voiced, tgt, sample_rate, hop_time)


def flatten_intensity(
    x: np.ndarray,
    sample_rate: int = 16_000,
    hop_time: float = 0.01,
    min_activity_rms: float = 1e-3,
) -> np.ndarray:
    """Equalize frame energy toward the mean active RMS."""
    x = np.asarray(x, dtype=np.float32)
    hop = int(hop_time * sample_rate)
    frame_len = int(0.025 * sample_rate)
    rms = frame_rms(x, frame_len, hop)
    active = rms > min_activity_rms
    if not active.any():
        return x
    target = rms[active].mean()
    gains = np.where(active, target / np.maximum(rms, 1e-8), 1.0)
    # per-sample gain by linear interpolation of frame gains
    ts = hop * np.arange(len(gains)) + frame_len // 2
    g = np.interp(np.arange(len(x)), ts, gains)
    return (x * g).astype(np.float32)


def low_pass_filter_resample(
    x: np.ndarray, cutoff_freq: int = 400, sample_rate: int = 16_000
) -> np.ndarray:
    """Resample to 2*cutoff and back (EXACT reference trick,
    functional.py:239-245) — removes all content above `cutoff_freq`."""
    from voiceactivityprojection_tpu_torch.ops.audio import resample

    inter = resample(np.asarray(x, dtype=np.float32), sample_rate, 2 * cutoff_freq)
    y = resample(inter, 2 * cutoff_freq, sample_rate)
    n = np.asarray(x).shape[-1]
    if y.shape[-1] < n:
        y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, n - y.shape[-1])])
    return y[..., :n]


# ---------------------------------------------------------------------------
# batch-module wrappers (API parity with vap/phrases/transforms.py:28-163 —
# callables over (B, C, n_samples) batches, looping per sample/channel like
# the reference nn.Module wrappers)
# ---------------------------------------------------------------------------
class _BatchTransform:
    def _one(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, waveform: np.ndarray, vad=None) -> np.ndarray:
        waveform = np.asarray(waveform, dtype=np.float32)
        assert waveform.ndim == 3, f"expected (B, C, n), got {waveform.shape}"
        out = np.empty_like(waveform)
        for b in range(waveform.shape[0]):
            for c in range(waveform.shape[1]):
                out[b, c] = self._one(waveform[b, c])
        return out


class FlatPitch(_BatchTransform):
    def __init__(self, target_f0: float = -1, sample_rate: int = 16_000,
                 hop_time: float = 0.01):
        self.target_f0 = None if target_f0 <= 0 else target_f0
        self.sample_rate = sample_rate
        self.hop_time = hop_time

    def _one(self, x):
        return flatten_pitch(x, self.target_f0, self.sample_rate, self.hop_time)


class ShiftPitch(_BatchTransform):
    def __init__(self, factor: float = 0.9, sample_rate: int = 16_000,
                 hop_time: float = 0.01):
        self.factor = factor
        self.sample_rate = sample_rate
        self.hop_time = hop_time

    def _one(self, x):
        return shift_pitch(x, self.factor, self.sample_rate, self.hop_time)


class FlatIntensity(_BatchTransform):
    def __init__(self, sample_rate: int = 16_000, hop_time: float = 0.01):
        self.sample_rate = sample_rate
        self.hop_time = hop_time

    def _one(self, x):
        return flatten_intensity(x, self.sample_rate, self.hop_time)


class LowPass(_BatchTransform):
    def __init__(self, cutoff_freq: int = 400, sample_rate: int = 16_000):
        self.cutoff_freq = cutoff_freq
        self.sample_rate = sample_rate

    def _one(self, x):
        return low_pass_filter_resample(x, self.cutoff_freq, self.sample_rate)


def duration_avg(
    x: np.ndarray,
    segments: List[Tuple[float, float]],
    sample_rate: int = 16_000,
) -> np.ndarray:
    """Uniform per-segment time-scaling: every segment is resampled to the
    mean segment duration (duration-flattening permutation of the phrases
    evaluation). segments: [(start_s, end_s), ...] must be ordered."""
    from voiceactivityprojection_tpu_torch.ops.audio import resample

    x = np.asarray(x, dtype=np.float32)
    if not segments:
        return x
    durs = [e - s for s, e in segments]
    mean_dur = float(np.mean(durs))
    mean_n = int(round(mean_dur * sample_rate))
    parts = []
    cursor = 0
    for (s, e) in segments:
        s_i, e_i = int(s * sample_rate), int(e * sample_rate)
        if s_i > cursor:
            parts.append(x[cursor:s_i])
        seg = x[s_i:e_i]
        if len(seg) > 1:
            # rational approximation of the stretch factor
            up, down = mean_n, max(len(seg), 1)
            stretched = resample(seg, down * 100, up * 100)
            parts.append(stretched)
        cursor = e_i
    if cursor < len(x):
        parts.append(x[cursor:])
    return np.concatenate(parts).astype(np.float32)


def time_scale_psola(
    x: np.ndarray,
    factor: float,
    sample_rate: int = 16_000,
    hop_time: float = 0.01,
) -> np.ndarray:
    """Duration change WITHOUT pitch change (TD-PSOLA time-scale
    modification): output length ≈ len(x) * factor; grains are copied
    UNRESAMPLED from the nearest analysis epoch to the time-mapped source
    position and overlap-added at their own source period, so the local
    periodicity (= F0 contour) survives the stretch. The resample-based
    ``duration_avg`` multiplies F0 by 1/stretch — unusable when the F0
    contour is the experimental variable."""
    x = np.asarray(x, dtype=np.float32)
    n = len(x)
    if n < 64 or abs(factor - 1.0) < 1e-3:
        return x.copy()
    f0, voiced = pitch_track(x, sample_rate, hop_time, frame_time=0.025)
    hop = int(hop_time * sample_rate)
    marks = np.asarray(_pitch_marks(x, f0, voiced, sample_rate, hop))
    n_out = int(round(n * factor))
    out = np.zeros(n_out, np.float32)
    norm = np.zeros(n_out, np.float32)
    default_period = int(sample_rate / 150)

    t_out = 0.0
    while t_out < n_out:
        t_src = min(t_out / factor, n - 1)
        mi = int(np.searchsorted(marks, t_src))
        if mi >= len(marks):
            mi = len(marks) - 1
        elif mi > 0 and abs(marks[mi - 1] - t_src) < abs(marks[mi] - t_src):
            mi -= 1
        m = int(marks[mi])
        fi = min(m // hop, len(f0) - 1)
        period = (
            int(round(sample_rate / f0[fi]))
            if voiced[fi] and f0[fi] > 0
            else default_period
        )
        g0, g1 = max(m - period, 0), min(m + period, n)
        grain = x[g0:g1]
        if len(grain) < 4:
            t_out += max(period, 8)
            continue
        center = m - g0
        win = np.hanning(len(grain)).astype(np.float32)
        o0 = int(t_out) - center
        lo, hi = max(o0, 0), min(o0 + len(grain), n_out)
        if hi > lo:
            gs = lo - o0
            out[lo:hi] += grain[gs : gs + hi - lo] * win[gs : gs + hi - lo]
            norm[lo:hi] += win[gs : gs + hi - lo]
        t_out += max(period, 8)
    return (out / np.maximum(norm, 1e-8)).astype(np.float32)


def duration_words_psola(
    x: np.ndarray,
    segments: List[Tuple[float, float]],
    sample_rate: int = 16_000,
) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """Equalize every word segment to the MEAN word duration with
    pitch-preserving PSOLA stretches (gaps between words pass through).
    Returns (audio, new word segments) — callers need the remapped
    alignments to rebuild VAD lists. Duration-cue neutralization for the
    F0-isolated corpus: after this, phrase-final lengthening carries no
    information, while each word's F0 contour is intact."""
    x = np.asarray(x, dtype=np.float32)
    if not segments:
        return x.copy(), []
    durs = [e - s for s, e in segments]
    mean_dur = float(np.mean(durs))
    parts = []
    new_segs: List[Tuple[float, float]] = []
    cursor = 0
    t_new = 0.0
    for (s, e) in segments:
        s_i, e_i = int(s * sample_rate), int(e * sample_rate)
        if s_i > cursor:
            parts.append(x[cursor:s_i])
            t_new += (s_i - cursor) / sample_rate
        seg = x[s_i:e_i]
        if len(seg) > 1:
            stretched = time_scale_psola(
                seg, mean_dur / max(durs[len(new_segs)], 1e-3), sample_rate
            )
            parts.append(stretched)
            new_segs.append((t_new, t_new + len(stretched) / sample_rate))
            t_new += len(stretched) / sample_rate
        else:
            new_segs.append((t_new, t_new))
        cursor = e_i
    if cursor < len(x):
        parts.append(x[cursor:])
    return np.concatenate(parts).astype(np.float32), new_segs


def f0_statistics(f0: np.ndarray, voiced: Optional[np.ndarray] = None):
    """(mean, std, voiced_ratio) over voiced frames — analogue of the
    reference's f0_statistics helper (vap/phrases/functional.py)."""
    f0 = np.asarray(f0)
    if voiced is None:
        voiced = f0 > 0
    if not voiced.any():
        return 0.0, 0.0, 0.0
    v = f0[voiced]
    return float(v.mean()), float(v.std()), float(voiced.mean())
