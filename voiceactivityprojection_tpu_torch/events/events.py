"""Turn-taking event extraction (hold/shift, backchannel, long/short).

Counterpart of ``voiceactivityprojection_tpu/events/events.py``, on the
port's own ``ops/vad.py``: host-side NumPy over the ground-truth VAD
(reference vap/events.py:21-838). The regions, and the negatives drawn
from ``random.Random(seed)`` in the same order, equal the JAX package's.

Event encoding: dialog state ds = 2*vad_B - vad_A + 1 in
{0: only A, 1: silence, 2: both, 3: only B}.
Templates over consecutive state runs:
  shift: [3,1,0] / [0,1,3]   (speaker change across silence)
  hold:  [0,1,0] / [3,1,3]   (same speaker across silence)
  backchannel: [0,1,0] on a single channel's activity.

All regions are (start_frame, end_frame, speaker) tuples, batched as
List[List[tuple]].

Two reference quirks, kept as the JAX package keeps them:
* Backchannel.__call__ passes `self.max_frame` where `frame_hz` is
  expected when max_time is overridden (vap/events.py:671) — frame_hz is
  used here (the override path is unused upstream).
* The pred_backchannel_neg count is taken from pred_shift counts, not
  pred_backchannel (vap/events.py:823) — replicated as-is since metric
  balancing depends on it.
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from voiceactivityprojection_tpu_torch.config import EventConfig
from voiceactivityprojection_tpu_torch.ops.vad import (
    find_island_idx_len,
    get_dialog_states_np,
)

Region = Tuple[int, int, int]
BatchRegions = List[List[Region]]

STATE_ONLY_A, STATE_SILENCE, STATE_BOTH, STATE_ONLY_B = 0, 1, 2, 3


def _frames(t: float, hz: int) -> int:
    return int(t * hz)


def fill_pauses(vad: np.ndarray, ds: np.ndarray) -> np.ndarray:
    """Fill hold-pattern silences (A-sil-A / B-sil-B) with the speaker's
    activity (vap/events.py:81-109)."""
    out = vad.copy()
    starts, durs, vals = find_island_idx_len(ds)
    if len(vals) < 3:
        return out
    for t in range(len(vals) - 2):
        a, b, c = vals[t], vals[t + 1], vals[t + 2]
        if b != STATE_SILENCE:
            continue
        if a == c == STATE_ONLY_A:
            out[starts[t + 1] : starts[t + 1] + durs[t + 1], 0] = 1.0
        elif a == c == STATE_ONLY_B:
            out[starts[t + 1] : starts[t + 1] + durs[t + 1], 1] = 1.0
    return out


def _triad_matches(
    vals: np.ndarray, templates: Sequence[Sequence[int]]
) -> List[Tuple[int, int]]:
    """All (template_row, position) where vals[pos:pos+3] equals a template.
    The row index IS the next-speaker id (template construction invariant).
    Emission order matches the reference's torch.where row-major order
    (vap/events.py:141-143): all row-0 matches first, then row-1."""
    hits = []
    for row, tmpl in enumerate(templates):
        tmpl = tuple(tmpl)
        for t in range(len(vals) - 2):
            if (vals[t], vals[t + 1], vals[t + 2]) == tmpl:
                hits.append((row, t))
    return hits


def hold_shift_regions(
    vad: np.ndarray,
    ds: np.ndarray,
    pre_cond_frames: int,
    post_cond_frames: int,
    prediction_region_frames: int,
    prediction_region_on_active: bool,
    long_onset_condition_frames: int,
    long_onset_region_frames: int,
    min_silence_frames: int,
    min_context_frames: int,
    max_frame: int,
) -> Dict[str, List[Region]]:
    """(contract of vap/events.py:112-333)."""
    starts, durs, vals = find_island_idx_len(ds)
    filled = fill_pauses(vad, ds)
    empty = {"shift": [], "hold": [], "long": [], "pred_shift": [], "pred_hold": []}
    if len(vals) < 3:
        return empty

    def match(templates, is_hold):
        region, pred_region, long_region = [], [], []
        for next_speaker, pos in _triad_matches(vals, templates):
            sil, onset = pos + 1, pos + 2
            prev_speaker = next_speaker if is_hold else 1 - next_speaker
            sil_start = int(starts[sil])
            if sil_start < min_context_frames:
                continue
            if sil_start >= max_frame:
                continue
            if durs[sil] < min_silence_frames:
                continue
            # pre: only prev_speaker active in the window before the silence
            pre_start = max(sil_start - pre_cond_frames, 0)
            if filled[pre_start:sil_start, prev_speaker].sum() != pre_cond_frames:
                continue
            if filled[pre_start:sil_start, 1 - prev_speaker].sum() != 0:
                continue
            # post: only next_speaker active in the window after the onset
            onset_start = int(starts[onset])
            onset_end = onset_start + post_cond_frames
            if filled[onset_start:onset_end, next_speaker].sum() != post_cond_frames:
                continue
            if filled[onset_start:onset_end, 1 - next_speaker].sum() != 0:
                continue
            region.append((sil_start, onset_start, int(next_speaker)))

            # long-onset region only for shifts with a long enough onset
            if not is_hold and durs[onset] >= long_onset_condition_frames:
                long_region.append(
                    (onset_start, onset_start + long_onset_region_frames, int(next_speaker))
                )

            # prediction region precedes the silence
            if prediction_region_on_active and durs[pos] < prediction_region_frames:
                continue
            pred_start = sil_start - prediction_region_frames
            if pred_start < min_context_frames:
                continue
            pred_region.append((pred_start, sil_start, int(next_speaker)))
        return region, pred_region, long_region

    shifts, pred_shifts, long_onsets = match(
        [[STATE_ONLY_B, STATE_SILENCE, STATE_ONLY_A],
         [STATE_ONLY_A, STATE_SILENCE, STATE_ONLY_B]],
        is_hold=False,
    )
    holds, pred_holds, _ = match(
        [[STATE_ONLY_A, STATE_SILENCE, STATE_ONLY_A],
         [STATE_ONLY_B, STATE_SILENCE, STATE_ONLY_B]],
        is_hold=True,
    )
    return {
        "shift": shifts,
        "hold": holds,
        "long": long_onsets,
        "pred_shift": pred_shifts,
        "pred_hold": pred_holds,
    }


def backchannel_regions(
    vad: np.ndarray,
    ds: np.ndarray,
    pre_cond_frames: int,
    post_cond_frames: int,
    prediction_region_frames: int,
    min_context_frames: int,
    max_bc_frames: int,
    max_frame: int,
) -> Dict[str, List[Region]]:
    """(contract of vap/events.py:336-412)."""
    filled = fill_pauses(vad, ds)
    backchannel, pred_backchannel = [], []
    for speaker in (0, 1):
        starts, durs, vals = find_island_idx_len(filled[:, speaker])
        if len(vals) < 3:
            continue
        for row, pos in _triad_matches(vals.astype(int), [[0, 1, 0]]):
            pre_sil, bc, post_sil = pos, pos + 1, pos + 2
            bc_start = int(starts[bc])
            if bc_start < min_context_frames:
                continue
            if bc_start >= max_frame:
                continue
            if durs[bc] > max_bc_frames:
                continue
            if durs[pre_sil] < pre_cond_frames:
                continue
            if durs[post_sil] < post_cond_frames:
                continue
            backchannel.append((bc_start, int(starts[post_sil]), speaker))
            pred_start = bc_start - prediction_region_frames
            if pred_start < min_context_frames:
                continue
            pred_backchannel.append((pred_start, bc_start, speaker))
    return {"backchannel": backchannel, "pred_backchannel": pred_backchannel}


def get_negative_sample_regions(
    vad: np.ndarray,
    ds: np.ndarray,
    min_pad_left_frames: int,
    min_pad_right_frames: int,
    min_region_frames: int,
    min_context_frames: int,
    max_frame: int,
) -> List[Region]:
    """Regions of sustained single-speaker activity usable as negatives for
    backchannel prediction (vap/events.py:415-478). The returned speaker is
    the OTHER (potential backchanneler)."""
    min_dur = min_pad_left_frames + min_pad_right_frames
    filled = fill_pauses(vad, ds)
    ds_fill = get_dialog_states_np(filled)
    starts, durs, vals = find_island_idx_len(ds_fill)

    out: List[Region] = []
    for cur_speaker, cur_state in enumerate((STATE_ONLY_A, STATE_ONLY_B)):
        other = 1 - cur_speaker
        for i, d in zip(starts[vals == cur_state], durs[vals == cur_state]):
            if d < min_dur:
                continue
            start = int(i + min_pad_left_frames)
            if start < min_context_frames:
                start = min_context_frames
            end = int(i + d - min_pad_right_frames)
            if end > max_frame:
                end = max_frame
            if end - start < min_region_frames:
                continue
            out.append((start, end, other))
    return out


class HoldShift:
    """Batched hold/shift extractor (vap/events.py:481-582)."""

    def __init__(
        self,
        pre_cond_time: float,
        post_cond_time: float,
        prediction_region_time: float,
        prediction_region_on_active: bool,
        long_onset_condition_time: float,
        long_onset_region_time: float,
        min_silence_time: float,
        min_context_time: float,
        max_time: float,
        frame_hz: int,
    ):
        self.frame_hz = frame_hz
        self.pre_cond_frame = _frames(pre_cond_time, frame_hz)
        self.post_cond_frame = _frames(post_cond_time, frame_hz)
        self.prediction_region_frame = _frames(prediction_region_time, frame_hz)
        self.prediction_region_on_active = prediction_region_on_active
        self.long_onset_condition_frames = _frames(long_onset_condition_time, frame_hz)
        self.long_onset_region_frames = _frames(long_onset_region_time, frame_hz)
        self.min_silence_frame = _frames(min_silence_time, frame_hz)
        self.min_context_frame = _frames(min_context_time, frame_hz)
        self.max_frame = _frames(max_time, frame_hz)

    def __call__(
        self, vad: np.ndarray, ds: Optional[np.ndarray] = None,
        max_time: Optional[float] = None,
    ) -> Dict[str, BatchRegions]:
        vad = np.asarray(vad)
        if vad.ndim != 3:
            raise ValueError(f"expected (B, T, 2), got {vad.shape}")
        max_frame = self.max_frame if max_time is None else _frames(max_time, self.frame_hz)
        if ds is None:
            ds = get_dialog_states_np(vad)
        keys = ("shift", "hold", "long", "pred_shift", "pred_hold")
        out: Dict[str, BatchRegions] = {k: [] for k in keys}
        for b in range(vad.shape[0]):
            r = hold_shift_regions(
                vad[b], ds[b],
                pre_cond_frames=self.pre_cond_frame,
                post_cond_frames=self.post_cond_frame,
                prediction_region_frames=self.prediction_region_frame,
                prediction_region_on_active=self.prediction_region_on_active,
                long_onset_condition_frames=self.long_onset_condition_frames,
                long_onset_region_frames=self.long_onset_region_frames,
                min_silence_frames=self.min_silence_frame,
                min_context_frames=self.min_context_frame,
                max_frame=max_frame,
            )
            for k in keys:
                out[k].append(r[k])
        return out


class Backchannel:
    """Batched backchannel extractor + negative regions (vap/events.py:585-706)."""

    def __init__(
        self,
        pre_cond_time: float,
        post_cond_time: float,
        prediction_region_time: float,
        min_context_time: float,
        negative_pad_left_time: float,
        negative_pad_right_time: float,
        max_bc_duration: float,
        max_time: float,
        frame_hz: int,
    ):
        if prediction_region_time <= 0:
            raise ValueError(f"prediction_region_time must be positive, got {prediction_region_time}")
        if negative_pad_left_time + negative_pad_right_time >= max_time:
            raise ValueError(
                f"bc negative pads ({negative_pad_left_time}+{negative_pad_right_time}s) "
                f"must fit inside max_time={max_time}s — lower "
                f"bc_negative_pad_*_time or raise max_time"
            )
        self.frame_hz = frame_hz
        self.pre_cond_frame = _frames(pre_cond_time, frame_hz)
        self.post_cond_frame = _frames(post_cond_time, frame_hz)
        self.prediction_region_frames = _frames(prediction_region_time, frame_hz)
        self.negatives_min_pad_left_frames = _frames(negative_pad_left_time, frame_hz)
        self.negatives_min_pad_right_frames = _frames(negative_pad_right_time, frame_hz)
        self.min_context_frame = _frames(min_context_time, frame_hz)
        self.max_bc_frame = _frames(max_bc_duration, frame_hz)
        self.max_frame = _frames(max_time, frame_hz)

    def sample_negative_segment(self, region: Region, rng: _random.Random) -> Region:
        start, end, speaker = region
        seg_start = rng.randint(start, end - self.prediction_region_frames)
        return (seg_start, seg_start + self.prediction_region_frames, speaker)

    def __call__(
        self, vad: np.ndarray, ds: Optional[np.ndarray] = None,
        max_time: Optional[float] = None,
    ) -> Dict[str, BatchRegions]:
        vad = np.asarray(vad)
        max_frame = self.max_frame if max_time is None else _frames(max_time, self.frame_hz)
        if ds is None:
            ds = get_dialog_states_np(vad)
        out: Dict[str, BatchRegions] = {
            "backchannel": [], "pred_backchannel": [], "pred_backchannel_neg": []
        }
        for b in range(vad.shape[0]):
            bc = backchannel_regions(
                vad[b], ds[b],
                pre_cond_frames=self.pre_cond_frame,
                post_cond_frames=self.post_cond_frame,
                min_context_frames=self.min_context_frame,
                prediction_region_frames=self.prediction_region_frames,
                max_bc_frames=self.max_bc_frame,
                max_frame=max_frame,
            )
            neg = get_negative_sample_regions(
                vad[b], ds[b],
                min_pad_left_frames=self.negatives_min_pad_left_frames,
                min_pad_right_frames=self.negatives_min_pad_right_frames,
                min_region_frames=self.prediction_region_frames,
                min_context_frames=self.min_context_frame,
                max_frame=max_frame,
            )
            out["backchannel"].append(bc["backchannel"])
            out["pred_backchannel"].append(bc["pred_backchannel"])
            out["pred_backchannel_neg"].append(neg)
        return out


class TurnTakingEvents:
    """Orchestrates HoldShift + Backchannel with cross-batch debt-balanced
    negative subsampling (vap/events.py:709-838)."""

    def __init__(self, conf: Optional[EventConfig] = None, seed: Optional[int] = None):
        self.conf = conf = conf or EventConfig()
        self.rng = _random.Random(seed)
        # balance debt carried across batches (vap/events.py:714-718)
        self.add_extra = {"shift": 0, "pred_shift": 0, "pred_backchannel": 0}
        self.min_silence_time = conf.metric_time + conf.metric_pad_time
        if conf.min_context_time >= conf.max_time:
            raise ValueError(
                f"min_context_time={conf.min_context_time}s must be below "
                f"max_time={conf.max_time}s"
            )

        self.HS = HoldShift(
            pre_cond_time=conf.sh_pre_cond_time,
            post_cond_time=conf.sh_post_cond_time,
            prediction_region_time=conf.prediction_region_time,
            prediction_region_on_active=conf.sh_prediction_region_on_active,
            long_onset_condition_time=conf.long_onset_condition_time,
            long_onset_region_time=conf.long_onset_region_time,
            min_silence_time=self.min_silence_time,
            min_context_time=conf.min_context_time,
            max_time=conf.max_time,
            frame_hz=conf.frame_hz,
        )
        self.BC = Backchannel(
            pre_cond_time=conf.bc_pre_cond_time,
            post_cond_time=conf.bc_post_cond_time,
            prediction_region_time=conf.prediction_region_time,
            negative_pad_left_time=conf.bc_negative_pad_left_time,
            negative_pad_right_time=conf.bc_negative_pad_right_time,
            max_bc_duration=conf.bc_max_duration,
            min_context_time=conf.min_context_time,
            max_time=conf.max_time,
            frame_hz=conf.frame_hz,
        )

    @staticmethod
    def _total(batched: BatchRegions) -> int:
        return sum(len(r) for r in batched)

    def _sample_equal_amounts(
        self, n_to_sample: int, pool: BatchRegions, event_type: str,
        is_backchannel: bool = False,
    ) -> BatchRegions:
        """Random subset of `pool` of size n_to_sample (+/- carried debt)."""
        batch_size = len(pool)
        subset: BatchRegions = [[] for _ in range(batch_size)]
        flat = [(b, r) for b in range(batch_size) for r in pool[b]]
        n_max = len(flat)
        if n_max < n_to_sample:
            self.add_extra[event_type] += n_to_sample - n_max
            n_to_sample = n_max
        else:
            extra = min(n_max - n_to_sample, self.add_extra[event_type])
            n_to_sample += extra
            self.add_extra[event_type] -= extra
        for idx in self.rng.sample(range(n_max), k=n_to_sample):
            b, entry = flat[idx]
            if is_backchannel:
                entry = self.BC.sample_negative_segment(entry, self.rng)
            subset[b].append(entry)
        return subset

    def __call__(
        self, vad: np.ndarray, max_time: Optional[float] = None
    ) -> Dict[str, BatchRegions]:
        vad = np.asarray(vad)
        if vad.ndim != 3:
            raise ValueError(f"expected (B, T, 2), got {vad.shape}")
        ds = get_dialog_states_np(vad)
        ret: Dict[str, BatchRegions] = {}
        ret.update(self.BC(vad, ds=ds, max_time=max_time))
        ret.update(self.HS(vad, ds=ds, max_time=max_time))

        # balance pred_shift negatives against pred_shift positives
        n_ps = self._total(ret["pred_shift"])
        ret["pred_shift_neg"] = self._sample_equal_amounts(
            n_ps, ret.pop("pred_hold"), event_type="pred_shift"
        )
        # reference counts pred_shift here, not pred_backchannel
        # (vap/events.py:823) — replicated
        n_bc = self._total(ret["pred_shift"])
        ret["pred_backchannel_neg"] = self._sample_equal_amounts(
            n_bc, ret["pred_backchannel_neg"],
            event_type="pred_backchannel", is_backchannel=True,
        )
        if self.conf.equal_hold_shift:
            n_shift = self._total(ret["shift"])
            ret["hold"] = self._sample_equal_amounts(
                n_shift, ret["hold"], event_type="shift"
            )
        ret["short"] = ret.pop("backchannel")
        return ret
