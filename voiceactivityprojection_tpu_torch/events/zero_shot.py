"""Zero-shot turn-taking probabilities from the 256-way VAP distribution.

Counterpart of ``voiceactivityprojection_tpu/events/zero_shot.py``.

Builds fixed index subsets of the codebook (reference: vap/zero_shot.py:9-157)
and computes dialog-state-conditioned next-speaker probabilities
(vap/zero_shot.py:222-264):

* silence subset: states where one speaker resumes (>= 2 trailing active
  bins) while the other is silent — renormalized shift-vs-hold marginals.
* active subset: end-of-segment x onset templates for shifts during speech;
  mirror-rolled for holds.
* backchannel subset: short burst (first 3 bins) for one speaker while the
  other keeps talking (n_bins == 4 only, like the reference).

All subsets are computed host-side with NumPy at construction, and the
per-frame math takes numpy arrays (a tensor goes to the host first).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from voiceactivityprojection_tpu_torch.ops.vad import get_dialog_states_np


def _encode(states: np.ndarray) -> np.ndarray:
    """(..., 2, n_bins) binary -> int index; LSB-first bit layout shared with
    ops.codebook.codebook_encode."""
    *lead, c, nb = states.shape
    flat = states.reshape(-1, c * nb)
    powers = 2 ** np.arange(c * nb)
    return (flat * powers).sum(-1).astype(np.int64).reshape(lead)


def end_of_segment_mono(n: int, max_active: int = 3) -> np.ndarray:
    """Rows: [0..0], [1,0..0], [1,1,0..0], ... (vap/zero_shot.py:9-19):
    activity that stops after k leading bins."""
    v = np.zeros((max_active + 1, n), dtype=np.float32)
    for i in range(max_active):
        v[i + 1, : i + 1] = 1
    return v


def all_permutations_mono(n: int, start: int = 0) -> np.ndarray:
    """All binary vectors of length n, MSB-first bit order like the
    reference's bin() string fill (vap/zero_shot.py:22-30)."""
    rows = [
        np.asarray([float(int(b)) for b in bin(i)[2:].zfill(n)], dtype=np.float32)
        for i in range(start, 2 ** n)
    ]
    return np.stack(rows)


def on_activity_change_mono(n: int = 4, min_active: int = 2) -> np.ndarray:
    """States whose LAST min_active bins are active, any prefix
    (vap/zero_shot.py:33-59)."""
    base = np.zeros(n, dtype=np.float32)
    if min_active > 0:
        base[-min_active:] = 1
    permutable = n - min_active
    if permutable > 0:
        perms = all_permutations_mono(permutable)
        out = np.tile(base, (perms.shape[0], 1))
        out[:, :permutable] = perms
        return out
    return base[None]


def combine_speakers(x1: np.ndarray, x2: np.ndarray, mirror: bool = False) -> np.ndarray:
    """Cartesian stack of per-speaker states (vap/zero_shot.py:62-75)."""
    if x1.ndim == 1:
        x1 = x1[None]
    if x2.ndim == 1:
        x2 = x2[None]
    vad = np.stack(
        [np.stack((a, b), axis=0) for a in x1 for b in x2]
    )  # (N, 2, n_bins)
    if mirror:
        flipped = np.stack((vad[:, 1], vad[:, 0]), axis=1)
        vad = np.stack((vad, flipped))
    return vad


def _sorted(idx: np.ndarray) -> np.ndarray:
    return np.sort(idx, axis=-1)


class ZeroShot:
    """Fixed-subset zero-shot probability extractor."""

    def __init__(self, n_bins: int = 4):
        self.n_bins = n_bins
        self.subset_silence, self.subset_silence_hold = self._init_silence()
        self.subset_active, self.subset_active_hold = self._init_active()
        self.bc_prediction = self._init_backchannel()

    def _init_silence(self) -> Tuple[np.ndarray, np.ndarray]:
        active = on_activity_change_mono(self.n_bins, min_active=2)
        non_active = np.zeros((1, active.shape[-1]), dtype=np.float32)
        shift_oh = combine_speakers(active, non_active, mirror=True)
        shift = _sorted(_encode(shift_oh))
        hold = shift[::-1].copy()
        return shift, hold

    def _init_active(self) -> Tuple[np.ndarray, np.ndarray]:
        eos = end_of_segment_mono(self.n_bins, max_active=2)
        nav = on_activity_change_mono(self.n_bins, min_active=2)
        shift = _sorted(_encode(combine_speakers(nav, eos, mirror=True)))
        zero = np.zeros((1, self.n_bins), dtype=np.float32)
        eos2 = on_activity_change_mono(self.n_bins, min_active=2)
        hold = _sorted(_encode(combine_speakers(zero, eos2, mirror=True)))
        return shift, hold

    def _init_backchannel(self) -> np.ndarray:
        if self.n_bins != 4:
            raise NotImplementedError("backchannel subset requires n_bins == 4")
        bc_speaker = all_permutations_mono(3, start=1)
        bc_speaker = np.concatenate(
            [bc_speaker, np.zeros((bc_speaker.shape[0], 1), dtype=np.float32)], axis=-1
        )
        current = all_permutations_mono(3, start=0)
        current = np.concatenate(
            [current, np.ones((current.shape[0], 1), dtype=np.float32)], axis=-1
        )
        return _encode(combine_speakers(bc_speaker, current, mirror=True))

    # -- probability extraction (numpy inputs)
    def _marginal(self, probs, pos_idx, neg_idx):
        ps = []
        for spk in (0, 1):
            joint = np.concatenate([pos_idx[spk], neg_idx[spk]], axis=-1)
            p_sum = probs[..., joint].sum(-1)
            ps.append(probs[..., pos_idx[spk]].sum(-1) / p_sum)
        return np.stack(ps, axis=-1)

    def probs_on_silence(self, probs):
        return self._marginal(probs, self.subset_silence, self.subset_silence_hold)

    def probs_on_active(self, probs):
        return self._marginal(probs, self.subset_active, self.subset_active_hold)

    def probs_backchannel(self, probs):
        ap = probs[..., self.bc_prediction[0]].sum(-1)
        bp = probs[..., self.bc_prediction[1]].sum(-1)
        return np.stack((ap, bp), axis=-1)

    def probs_next_speaker(self, probs: np.ndarray, va: np.ndarray) -> np.ndarray:
        """Dialog-state-dispatched next-speaker probabilities
        (vap/zero_shot.py:222-264)."""
        probs = np.asarray(probs)
        va = np.asarray(va)
        sil = self.probs_on_silence(probs)
        act = self.probs_on_active(probs)

        ds = get_dialog_states_np(va)
        p_a = np.zeros(va.shape[:-1], dtype=probs.dtype)
        p_b = np.zeros_like(p_a)

        w = ds == 1  # silence
        p_a[w] = sil[w][..., 0]
        p_b[w] = sil[w][..., 1]

        w = ds == 0  # A speaking: use P(B next | active)
        p_b[w] = act[w][..., 1]
        p_a[w] = 1 - act[w][..., 1]

        w = ds == 3  # B speaking
        p_a[w] = act[w][..., 0]
        p_b[w] = 1 - act[w][..., 0]

        w = ds == 2  # overlap: renormalize
        s = act[w][..., 0] + act[w][..., 1]
        p_a[w] = act[w][..., 0] / s
        p_b[w] = act[w][..., 1] / s

        return np.stack((p_a, p_b), axis=-1)

    def get_probs(self, logits: np.ndarray, va: np.ndarray) -> Dict[str, np.ndarray]:
        logits = np.asarray(logits)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        nmax = probs.shape[-2]
        return {
            "p": self.probs_next_speaker(probs, np.asarray(va)[:, :nmax]),
            "p_bc": self.probs_backchannel(probs),
        }
