"""Figures (JAX: utils/plot.py; reference vap/plot_utils.py).

Mel-spectrogram panels, VAD overlays, next-speaker probability panels (with
the backchannel band), event shading, word alignments on a seconds or a
frame axis, the stereo summary figure of ``run --plot`` (``plot_stereo``),
the larger ``plot_vap`` figure, F0 tracks (``ops/prosody.pitch_track``),
evaluation-score bars, the phrase-sample figure and the threshold curves
of the evaluation.

Host figures from numpy arrays, on the port's ``ops/audio`` and
``ops/prosody``. matplotlib (the Agg backend) is imported only inside the
functions that need it (``_plt``), never when this module is imported:
the port runs without it, and then makes no figure.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_melspectrogram(
    waveform: np.ndarray,
    ax,
    n_mels: int = 80,
    frame_time: float = 0.05,
    sample_rate: int = 16_000,
    cmap: str = "magma",
):
    """Log-mel image on an axis, x-axis in SECONDS (so panels with
    probability curves can share it)."""
    from voiceactivityprojection_tpu_torch.ops.audio import log_mel_spectrogram

    w = np.asarray(waveform)
    hop = int(frame_time * sample_rate)
    mel = log_mel_spectrogram(w, n_mels=n_mels, hop_length=hop, sample_rate=sample_rate)
    duration = w.shape[-1] / sample_rate
    ax.imshow(
        mel, aspect="auto", origin="lower", interpolation="none", cmap=cmap,
        extent=[0.0, duration, 0.0, float(n_mels)],
    )
    ax.set_yticks([])
    return ax


def plot_vad(x: np.ndarray, vad: np.ndarray, ax, ypad: float = 0.0, color="w", **kw):
    """Step-plot a binary VAD track scaled onto the current axis."""
    y0, y1 = ax.get_ylim()
    scaled = y0 + ypad + np.asarray(vad) * (y1 - y0 - 2 * ypad) * 0.95
    ax.step(np.asarray(x), scaled, where="post", color=color, linewidth=2, **kw)
    return ax


def plot_next_speaker_probs(
    p: np.ndarray,
    ax,
    frame_hz: int = 50,
    color=("b", "orange"),
    p_bc: Optional[np.ndarray] = None,
    vad: Optional[np.ndarray] = None,
    alpha_bc: float = 0.3,
    legend: bool = False,
    label=("A", "B"),
):
    """Filled area plot of per-speaker next-speaker probability, with the
    optional backchannel-probability band folded around the 0.5 midline
    (reference plot_utils.py:440-511; p_bc is masked to non-speech frames
    when vad is given)."""
    p = np.asarray(p)
    if p.ndim == 2:
        pA = p[:, 0]  # speakers sum to 1; plot channel 0
    else:
        pA = p
    x = np.arange(pA.shape[0]) / frame_hz
    ax.fill_between(x, 0.5, pA, where=pA >= 0.5, color=color[0], alpha=0.7, label=label[0])
    ax.fill_between(x, pA, 0.5, where=pA < 0.5, color=color[1], alpha=0.7, label=label[1])
    ax.axhline(0.5, color="k", linewidth=0.8, linestyle=":")
    ax.set_ylim([0, 1])
    if p_bc is not None:
        p_bc = np.asarray(p_bc)
        n = p_bc.shape[0]
        xb = np.arange(n) / frame_hz
        if vad is not None:
            p_bc = p_bc * (1.0 - np.asarray(vad)[:n].astype(np.float32))
        ax.plot(xb, 0.5 + p_bc[:, 0] / 2, color="darkgreen", linewidth=0.8)
        ax.plot(xb, 0.5 - p_bc[:, 1] / 2, color="darkgreen", linewidth=0.8)
        ax.fill_between(xb, 0.5 + p_bc[:, 0] / 2, 0.5, color="g", alpha=alpha_bc, label="BC")
        ax.fill_between(xb, 0.5, 0.5 - p_bc[:, 1] / 2, color="g", alpha=alpha_bc)
    if legend:
        ax.legend(loc="lower left", fontsize=8)
    return ax


def plot_probs(x: np.ndarray, p: np.ndarray, ax, color=("b", "orange"),
               label=("A", "B"), alpha_ns: float = 0.6, fontsize: int = 12,
               no_xticks: bool = True):
    """Single-speaker probability panel over an explicit seconds axis with
    SHIFT/HOLD y-tick labels (reference plot_utils.py:54-99)."""
    p = np.asarray(p).ravel()
    x = np.asarray(x).ravel()
    ax.fill_between(x, 0.5, p, where=p > 0.5, alpha=alpha_ns, color=color[0], label=label[0])
    ax.fill_between(x, p, 0.5, where=p < 0.5, alpha=alpha_ns, color=color[1], label=label[1])
    ax.plot(x, p, color="k", linewidth=1)
    ax.set_yticks([0.25, 0.75], ["SHIFT", "HOLD"], fontsize=fontsize)
    ax.set_ylim([0, 1])
    ax.set_xlim([0, x[-1]])
    ax.legend(loc="lower left")
    ax.axhline(y=0.5, linestyle="dashed", linewidth=2, color="k")
    if no_xticks:
        ax.set_xticks([])
    return ax


def plot_event(events, ax, color="r", frame_hz: int = 50, alpha: float = 0.4):
    """Shade (start, end, channel) event regions onto a pair of per-channel
    axes (reference plot_utils.py:102-114; frames -> seconds)."""
    for start, end, ch in events:
        a = ax[ch]
        y0, y1 = a.get_ylim()
        a.fill_betweenx(
            y=[y0 + 1, y1 - 1],
            x1=[start / frame_hz] * 2,
            x2=[end / frame_hz] * 2,
            color=color,
            alpha=alpha,
        )
    return ax


def plot_stereo(
    waveform: np.ndarray,
    p_now: np.ndarray,
    p_future: np.ndarray,
    vad: np.ndarray,
    savepath: Optional[str] = None,
    frame_hz: int = 50,
    sample_rate: int = 16_000,
    figsize=(12, 8),
):
    """Summary figure: per-channel mel + model VAD, p_now, p_future panels
    (contract of plot_utils.plot_stereo used at run.py:267-279)."""
    plt = _plt()
    fig, ax = plt.subplots(4, 1, figsize=figsize, sharex=True)

    waveform = np.asarray(waveform)
    T = np.asarray(p_now).shape[0]
    x = np.arange(T) / frame_hz  # shared seconds axis

    plot_melspectrogram(waveform[0], ax=ax[0], sample_rate=sample_rate)
    ax[0].set_ylabel("A")
    ax[0].set_ylim([0, 80])
    plot_vad(x, np.asarray(vad)[:T, 0], ax[0], ypad=2)

    plot_melspectrogram(waveform[1], ax=ax[1], sample_rate=sample_rate)
    ax[1].set_ylabel("B")
    ax[1].set_ylim([0, 80])
    plot_vad(x, np.asarray(vad)[:T, 1], ax[1], ypad=2)

    plot_next_speaker_probs(np.asarray(p_now)[:T], ax[2], frame_hz)
    ax[2].set_ylabel("p_now")
    plot_next_speaker_probs(np.asarray(p_future)[:T], ax[3], frame_hz)
    ax[3].set_ylabel("p_future")
    ax[3].set_xlabel("time (s)")

    plt.tight_layout()
    if savepath:
        fig.savefig(savepath, dpi=100)
        plt.close(fig)
    return fig, ax


def plot_entropy(H: np.ndarray, ax, frame_hz: int = 50, color="g"):
    H = np.asarray(H)
    x = np.arange(H.shape[0]) / frame_hz
    ax.plot(x, H, color=color, linewidth=2)
    ax.set_ylim([0, 8])
    ax.set_ylabel("H (bits)")
    return ax


def plot_waveform(waveform: np.ndarray, ax, sample_rate: int = 16_000, color="b"):
    w = np.asarray(waveform).ravel()
    x = np.arange(len(w)) / sample_rate
    ax.plot(x, w, color=color, linewidth=0.5)
    ax.set_ylim([-1, 1])
    return ax


def to_mono(waveform: np.ndarray) -> np.ndarray:
    """Stereo -> mono mixdown keeping the channel axis (reference
    plot_utils.py:258-266)."""
    w = np.asarray(waveform)
    if w.ndim == 3:
        return w.mean(-2, keepdims=True)
    if w.ndim == 2 and w.shape[0] == 2:
        return w.mean(0, keepdims=True)
    raise NotImplementedError(f"{w.shape} must be (N, 2, n) or (2, n)")


def plot_words_time(words, ax, starts, ends=None, rows: int = 4,
                    fontsize: int = 14, color: str = "w",
                    linewidth: int = 1, linealpha: float = 0.6):
    """Word annotations over a seconds x-axis: dashed start/end lines and
    row-cycled labels (reference plot_utils.py:117-176)."""
    if ends is None:
        ends = [None] * len(starts)
    y0, y1 = ax.get_ylim()
    diff = y1 - y0
    pad = diff * 0.05
    for i, (word, s, e) in enumerate(zip(words, starts, ends)):
        yy = pad + y0 + diff * (i % rows) / rows
        if e is not None:
            x_text, align = s + 0.5 * (e - s), "center"
        else:
            x_text, align = s, "left"
        ax.vlines(s, ymin=y0 + pad, ymax=y1 - pad, linestyle="dashed",
                  linewidth=linewidth, color=color, alpha=linealpha)
        ax.text(x=x_text, y=yy, s=word, fontsize=fontsize, fontweight="bold",
                horizontalalignment=align, color=color)
        if e is not None:
            ax.vlines(e, ymin=y0 + pad, ymax=y1 - pad, linestyle="dashed",
                      linewidth=linewidth, color=color, alpha=linealpha)
    return ax


def plot_words(words, word_starts, ax, word_ends=None, rows: int = 4,
               frame_hz: int = 50, fontsize: int = 12, color: str = "k",
               linewidth: int = 2):
    """Word annotations over a FRAME-index x-axis; the last word end gets a
    red end-of-turn marker (reference plot_utils.py:595-654)."""
    if word_ends is None:
        word_ends = [None] * len(word_starts)
    y0, y1 = ax.get_ylim()
    diff = y1 - y0
    pad = diff * 0.05
    for i, (word, s, e) in enumerate(zip(words, word_starts, word_ends)):
        yy = pad + y0 + diff * (i % rows) / rows
        start_f = s * frame_hz
        if e is not None:
            x_text, align = start_f + 0.5 * frame_hz * (e - s), "center"
        else:
            x_text, align = start_f, "left"
        ax.vlines(start_f, ymin=y0 + pad, ymax=y1 - pad, linestyle="dashed",
                  linewidth=linewidth, color=color, alpha=0.8)
        ax.text(x=x_text, y=yy, s=word, fontsize=fontsize,
                horizontalalignment=align, color=color)
    if word_ends and word_ends[0] is not None:
        ax.vlines(word_ends[-1] * frame_hz, ymin=y0 + pad, ymax=y1 - pad,
                  linewidth=3, color="r", alpha=0.8)
    return ax


def plot_f0(waveform: np.ndarray, ax, sample_rate: int = 16_000,
            hop_time: float = 0.1, color: str = "b", markersize: int = 3):
    """F0 scatter over seconds using the DSP pitch track (stand-in for the
    reference's praat pitch; reference plot_utils.py:329-352)."""
    from voiceactivityprojection_tpu_torch.ops.prosody import pitch_track

    f0, _ = pitch_track(np.asarray(waveform).ravel(),
                        sample_rate=sample_rate, hop_time=hop_time)
    f0 = np.where(f0 == 0, np.nan, f0)
    x = np.arange(f0.shape[-1]) * hop_time
    ax.plot(x, f0, "o", markersize=markersize, color=color)
    y0, y1 = ax.get_ylim()
    if (y1 - y0) < 10:
        ax.set_ylim([y0 - 5, y1 + 5])
    ax.set_xlim([0, x[-1]])
    ax.set_ylabel("F0 (Hz)", fontsize=14)
    ax.yaxis.tick_right()
    return ax


def plot_spectrogram(spec: np.ndarray, ax, vmin: float = -1.5, vmax: float = 1.5):
    """Raw (freq, time) spectrogram image (reference plot_utils.py:355-358)."""
    ax.imshow(np.asarray(spec), aspect="auto", origin="lower", vmin=vmin, vmax=vmax)
    return ax


def plot_stereo_mel_spec(waveform: np.ndarray, ax, vad: Optional[np.ndarray] = None,
                         mel_spec: Optional[np.ndarray] = None,
                         sample_rate: int = 16_000, fontsize: int = 12):
    """Two per-channel mel panels with VAD overlays on a frame-index axis
    (reference plot_utils.py:361-396)."""
    from voiceactivityprojection_tpu_torch.ops.audio import log_mel_spectrogram

    if mel_spec is None:
        w = np.asarray(waveform)
        mel_spec = np.stack([log_mel_spectrogram(w[c], sample_rate=sample_rate)
                             for c in range(w.shape[0])])
    mel_spec = np.asarray(mel_spec)
    colors = ["b", "orange"]
    n_channels, n_mels, n_frames = mel_spec.shape
    for ch in range(n_channels):
        ax[ch].imshow(mel_spec[ch], aspect="auto", origin="lower", vmin=-1.5, vmax=1.5)
        if vad is not None:
            ax[ch].plot(np.asarray(vad)[:n_frames, ch] * (n_mels - 1),
                        alpha=0.9, linewidth=2, color=colors[ch])
        ax[ch].set_xticks([])
        ax[ch].set_yticks([])
    ax[0].set_ylabel("A", fontsize=fontsize)
    ax[1].set_ylabel("B", fontsize=fontsize)
    return ax


def plot_mel_spec(waveform: np.ndarray, ax, vad: Optional[np.ndarray] = None,
                  mel_spec: Optional[np.ndarray] = None, no_ticks: bool = False,
                  cmap: str = "inferno", interpolation: bool = True,
                  frame_hz: int = 50, sample_rate: int = 16_000):
    """Single-channel mel panel on a frame-index axis with an optional VAD
    overlay (reference plot_utils.py:399-437)."""
    from voiceactivityprojection_tpu_torch.ops.audio import log_mel_spectrogram

    if mel_spec is None:
        hop = int(sample_rate / frame_hz)
        mel_spec = log_mel_spectrogram(np.asarray(waveform).ravel(),
                                       hop_length=hop, sample_rate=sample_rate)
    mel_spec = np.asarray(mel_spec)
    if mel_spec.ndim == 3 and mel_spec.shape[0] == 1:
        mel_spec = mel_spec[0]
    if mel_spec.ndim != 2:
        raise NotImplementedError("multi-channel: use plot_stereo_mel_spec")
    n_mels, n_frames = mel_spec.shape
    ax.imshow(mel_spec, aspect="auto", origin="lower", cmap=cmap,
              interpolation=None if interpolation else "none")
    if vad is not None:
        ax.plot(np.asarray(vad)[:n_frames] * (n_mels - 1), alpha=0.9,
                linewidth=5, color="b")
    if no_ticks:
        ax.set_xticks([])
        ax.set_yticks([])
    return ax


def plot_vap(waveform: np.ndarray, p_now: np.ndarray,
             p_fut: Optional[np.ndarray] = None, vad: Optional[np.ndarray] = None,
             frame_hz: int = 50, sample_rate: int = 16_000,
             savepath: Optional[str] = None, figsize=(16, 9)):
    """Large summary figure: overlaid waveforms, per-channel mels with VAD,
    and p_now (+ optional p_future) probability panels (reference
    plot_utils.py:179-254)."""
    plt = _plt()
    w = np.asarray(waveform)
    if w.ndim != 2 or w.shape[0] != 2:
        raise ValueError(f"expected (2, n_samples), got {w.shape}")
    p_now = np.asarray(p_now)
    if p_now.ndim == 2:
        p_now = p_now[:, 0]
    n = 4 if p_fut is None else 5
    xx = np.arange(len(p_now)) / frame_hz

    fig, ax = plt.subplots(n, 1, figsize=figsize, sharex=False)
    plot_waveform(w[0], ax=ax[0], sample_rate=sample_rate, color="b")
    plot_waveform(w[1], ax=ax[0], sample_rate=sample_rate, color="orange")
    ax[0].set_xticks([])

    for ch in (0, 1):
        plot_melspectrogram(w[ch], ax=ax[1 + ch], sample_rate=sample_rate,
                            frame_time=0.01)
        ax[1 + ch].set_ylim([0, 80])
        if vad is not None:
            v = np.asarray(vad)
            xvad = np.arange(v.shape[0]) / frame_hz
            plot_vad(xvad, v[:, ch], ax=ax[1 + ch], ypad=2,
                     color=("b", "orange")[ch])

    plot_probs(xx, p_now, ax=ax[3], label=("A now", "B now"),
               no_xticks=p_fut is not None)
    if p_fut is not None:
        p_fut = np.asarray(p_fut)
        if p_fut.ndim == 2:
            p_fut = p_fut[:, 0]
        plot_probs(xx, p_fut, ax=ax[4], label=("A future", "B future"),
                   color=("blue", "green"), no_xticks=False)
    plt.tight_layout()
    plt.subplots_adjust(left=0.08, hspace=0.04)
    if savepath:
        fig.savefig(savepath, dpi=100)
        plt.close(fig)
    return fig, ax


def plot_evaluation_scores(scores, savepath: Optional[str] = None,
                           figsize=(6, 4)):
    """Bar chart of the four F1w event metrics with threshold annotations
    (reference plot_utils.py:514-591; accepts a dict or a JSON path)."""
    from voiceactivityprojection_tpu_torch.utils.io import read_json

    plt = _plt()
    if isinstance(scores, str):
        scores = read_json(scores)
    keys = ["f1_hold_shift", "f1_predict_shift", "f1_short_long", "f1_bc_prediction"]
    heights = [float(scores.get(k, 0.0)) for k in keys]
    fig, ax = plt.subplots(1, 1, figsize=figsize)
    ax.bar(x=list(range(4)), height=heights)
    for xx, k in enumerate(keys):
        ax.text(x=xx, y=heights[xx], s=f"{heights[xx]:.3f}", fontsize=12,
                horizontalalignment="center")
    if "shift" in scores and "hold" in scores:
        ax.text(x=0, y=max(heights[0] - 0.1, 0),
                s=f'shift: {scores["shift"]["f1"]:.3f}\nhold: {scores["hold"]["f1"]:.3f}',
                fontsize=10, horizontalalignment="center")
    thr = [scores.get(k) for k in
           ("threshold_short_long", "threshold_pred_shift", "threshold_pred_bc")]
    if all(t is not None for t in thr):
        ax.text(x=3.4, y=0.85,
                s=f"Thresholds\nSL: {thr[0]:.3f}\nPred-S: {thr[1]:.3f}\nPred-BC: {thr[2]:.3f}",
                horizontalalignment="right", fontsize=10)
    if "loss" in scores:
        ax.set_title(f"Turn-taking Events: loss={scores['loss']:.3f}")
    ax.set_xticks([0, 1, 2, 3])
    ax.set_xticklabels(["SH", "Pred-S", "SL", "Pred-BC"], fontsize=14)
    ax.set_ylim([0.5, 1])
    ax.set_ylabel("F1 (weighted)", fontsize=14)
    if savepath:
        fig.savefig(savepath, dpi=100)
        plt.close(fig)
    return fig, ax, scores


def plot_sample_waveform(waveform: np.ndarray, ax, words=None, starts=None,
                         ends=None, downsample: int = 10,
                         sample_rate: int = 16_000):
    """Phrase-sample waveform panel with word annotations on the
    downsampled-index axis (reference plot_utils.py:657-683)."""
    x = np.asarray(waveform).ravel()[::downsample]
    ax.plot(x, color="lightblue", zorder=0)
    ax.set_xlim([0, len(x)])
    ax.set_xticks([])
    ax.set_ylim([-1, 1])
    ax.set_yticks([])
    ax.set_ylabel("waveform", fontsize=14)
    if words is not None and starts is not None:
        plot_words(words, word_starts=starts, word_ends=ends, ax=ax,
                   fontsize=14, linewidth=2,
                   frame_hz=int(sample_rate / downsample))
    return ax


def plot_sample_mel_spec(waveform: np.ndarray, ax, words=None, starts=None,
                         ends=None, frame_hz: int = 50,
                         sample_rate: int = 16_000):
    """Phrase-sample mel panel with white word annotations (reference
    plot_utils.py:686-707)."""
    plot_mel_spec(np.asarray(waveform).ravel(), ax=ax, cmap="magma",
                  no_ticks=True, frame_hz=frame_hz, sample_rate=sample_rate)
    ax.yaxis.tick_right()
    ax.set_ylabel("Mel (Hz)", fontsize=14)
    if words is not None and starts is not None:
        plot_words(words, word_starts=starts, word_ends=ends, ax=ax,
                   fontsize=14, frame_hz=frame_hz, color="w")
    return ax


def plot_sample_f0(waveform: np.ndarray, ax, sample_rate: int = 16_000,
                   color: str = "b", markersize: int = 3):
    """Phrase-sample F0 panel (reference plot_utils.py:710-730)."""
    return plot_f0(waveform, ax, sample_rate=sample_rate, hop_time=0.01,
                   color=color, markersize=markersize)


def plot_phrases_sample(
    sample: dict,
    p_now: np.ndarray,
    p_future: np.ndarray,
    savepath: Optional[str] = None,
    frame_hz: int = 50,
    sample_rate: int = 16_000,
    figsize=(12, 6),
):
    """Phrase-probe figure: mel + word alignment + p panels with EOT/SCP
    markers (contract of reference plot_utils phrase figure)."""
    plt = _plt()
    fig, ax = plt.subplots(3, 1, figsize=figsize, sharex=False)

    w = np.asarray(sample["waveform"])[0]
    plot_melspectrogram(w, ax=ax[0], sample_rate=sample_rate)
    ax[0].set_title(
        f"{sample['phrase']} ({sample['long_short']}, {sample['gender']})",
        fontsize=10,
    )
    T = np.asarray(p_now).shape[0]
    for i, (word, start) in enumerate(zip(sample["words"], sample["starts"])):
        xpos = start * frame_hz / T * ax[0].get_xlim()[1]
        ax[0].axvline(xpos, color="w", linewidth=0.5, alpha=0.5)
        ax[0].text(xpos, 70, word, color="w", fontsize=7, rotation=45)

    for axis, p, name in ((ax[1], p_now, "p_now"), (ax[2], p_future, "p_future")):
        plot_next_speaker_probs(np.asarray(p), axis, frame_hz)
        axis.set_ylabel(name)
        axis.axvline(sample["end"] / frame_hz, color="r", linewidth=1.5, label="EOT")
        if sample["long_short"] == "long":
            axis.axvline(sample["scp"] / frame_hz, color="m", linewidth=1.5, label="SCP")
    ax[1].legend(loc="upper left", fontsize=7)

    plt.tight_layout()
    if savepath:
        fig.savefig(savepath, dpi=100)
        plt.close(fig)
    return fig, ax


def plot_threshold_curves(
    curves: dict, savepath: Optional[str] = None, title: str = "", figsize=(8, 4)
):
    """F1/balanced-accuracy/PR curves from train.evaluation.get_curves
    (contract of reference evaluation.py curve plots)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=figsize)
    t = np.asarray(curves["thresholds"])
    for key, style in (
        ("f1_weighted", "-"),
        ("balanced_accuracy", "--"),
        ("precision", ":"),
        ("recall", "-."),
    ):
        ax.plot(t, np.asarray(curves[key]), style, label=key)
    best = int(np.argmax(curves["f1_weighted"]))
    ax.axvline(t[best], color="r", linewidth=1, alpha=0.6)
    ax.set_xlabel("threshold")
    ax.set_ylim([0, 1.02])
    ax.legend(fontsize=8)
    if title:
        ax.set_title(title)
    plt.tight_layout()
    if savepath:
        fig.savefig(savepath, dpi=100)
        plt.close(fig)
    return fig, ax
