"""Offline extraction for audio of any length (JAX: inference/extraction.py).

Up to ``MAX_SINGLE_SHOT_TIME`` (160 s) a file runs in one forward. Longer
audio runs as windows of ``context_time + step_time`` seconds every
``step_time`` seconds: the first window keeps all its frames, each later one
its last ``step_time``, and where the windows stop short of the end one more
window, flush with the end, adds the frames not yet covered. Windows go
through the model ``chunk_batch`` at a time, the last batch padded with
silent rows whose outputs are dropped, so every call has one shape.

The waveform, the model calls and the stitching stay on the model's
device; only the stitched outputs come to the host, as numpy arrays with a
leading batch axis of 1 (``probs``, ``vad``, ``p_now``, ``p_future``, ``H``
and, given ground-truth VAD, ``loss``).
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.models.vap import VapModel
from voiceactivityprojection_tpu_torch.ops import objective_variants as ov
from voiceactivityprojection_tpu_torch.ops.codebook import get_labels
from voiceactivityprojection_tpu_torch.ops.losses import loss_vap
from voiceactivityprojection_tpu_torch.utils.io import write_json

# single shot up to this length (the reference's threshold)
MAX_SINGLE_SHOT_TIME = 160.0


def _host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in out.items()}


class VapExtractor:
    def __init__(
        self,
        model: VapModel,
        context_time: float = 20.0,
        step_time: float = 5.0,
        chunk_batch: int = 8,
    ):
        self.model = model
        self.context_time = context_time
        self.step_time = step_time
        self.chunk_batch = chunk_batch
        sr, hz = model.conf.sample_rate, model.conf.frame_hz
        self.chunk_time = context_time + step_time
        self.chunk_samples = int(self.chunk_time * sr)
        self.step_samples = int(step_time * sr)
        self.chunk_frames = int(self.chunk_time * hz)
        self.step_frames = int(step_time * hz)

    def _stereo(self, waveform) -> torch.Tensor:
        """(2, n), (1, n) (a silent channel added), (1, 2, n) or (1, 1, n)
        -> (1, 2, n) float32 on the model's device."""
        x = torch.as_tensor(waveform, dtype=torch.float32, device=self.model.device)
        if x.ndim == 2:
            x = x[None]
        if x.ndim == 3 and x.shape[1] == 1:
            x = torch.cat([x, torch.zeros_like(x)], dim=1)
        if x.ndim != 3 or x.shape[:2] != (1, 2):
            raise ValueError(f"expected one stereo signal, got {tuple(x.shape)}")
        return x

    def extract(self, waveform, vad: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """One file: single shot up to 160 s, else ``step_extraction``."""
        wave = self._stereo(waveform)
        if wave.shape[-1] / self.model.conf.sample_rate <= MAX_SINGLE_SHOT_TIME:
            return _host(self.model.probs(wave, vad=vad))
        return self.step_extraction(wave, vad=vad)

    def step_extraction(self, waveform, vad: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Sliding windows, ``chunk_batch`` to a model call, stitched."""
        wave = self._stereo(waveform)
        sr, hz = self.model.conf.sample_rate, self.model.conf.frame_hz
        n = wave.shape[-1]
        if n <= self.chunk_samples:
            # shorter than one window: one pass is the chunked result
            return _host(self.model.probs(wave, vad=vad))

        starts = list(range(0, n - self.chunk_samples + 1, self.step_samples))
        tail = starts[-1] + self.chunk_samples < n  # one more window, flush with the end
        offsets = starts + ([n - self.chunk_samples] if tail else [])
        B = self.chunk_batch
        outs: List[Dict[str, torch.Tensor]] = []
        for i in range(0, len(offsets), B):
            group = torch.stack([wave[0, :, s : s + self.chunk_samples] for s in offsets[i : i + B]])
            rows = group.shape[0]
            if rows < B:
                group = torch.cat([group, group.new_zeros(B - rows, *group.shape[1:])])
            outs.append({k: v[:rows] for k, v in self.model.probs(group).items()})
        merged = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

        n_main = len(starts)
        frames_done = self.chunk_frames + (n_main - 1) * self.step_frames
        remain = int(n / sr * hz) - frames_done  # the reference's frame count
        stitched = {}
        for k, v in merged.items():
            parts = [v[0]] + [v[c][-self.step_frames :] for c in range(1, n_main)]
            if tail and remain > 0:
                parts.append(v[n_main][-remain:])
            stitched[k] = torch.cat(parts, dim=0)[None]
        if vad is not None:
            stitched["loss"] = self._stitched_loss(stitched["probs"], vad)
        return _host(stitched)

    def _stitched_loss(self, probs: torch.Tensor, vad) -> torch.Tensor:
        """Per-frame loss on the stitched timeline for the config's
        representation, from logits rebuilt out of the probabilities:
        log(p) for the softmax objective (its loss ignores a shift),
        logit(p) for the Bernoulli ones."""
        conf = self.model.conf
        vad = torch.as_tensor(np.asarray(vad), dtype=torch.float32, device=probs.device)
        rep = conf.representation
        if rep == "discrete":
            labels = get_labels(vad, conf.bin_frames)
            T = min(probs.shape[1], labels.shape[1])
            logits = torch.log(probs[:, :T].clamp_min(1e-12))
            return loss_vap(logits, labels[:, :T], reduction="none")
        p = probs.clamp(1e-7, 1.0 - 1e-7)
        logits = torch.log(p) - torch.log1p(-p)
        if rep == "independent":
            labels = ov.get_labels_independent(vad, conf.bin_frames)
            T = min(logits.shape[1], labels.shape[1])
            return ov.loss_vap_independent(logits[:, :T], labels[:, :T], reduction="none")
        if rep == "comparative":
            labels = ov.get_labels_comparative(vad, conf.bin_frames)
            T = min(logits.shape[1], labels.shape[1])
            return ov.loss_vap_comparative(logits[:, :T], labels[:, :T], reduction="none")
        raise ValueError(f"unknown representation {rep!r}")

    # ------------------------------------------------------ minimal outputs --
    def get_minimal_output(self, out: Dict[str, np.ndarray]) -> Dict[str, list]:
        """Speaker A's p_now / p_future, the model VAD per speaker, H and
        the loss where there is one, as lists."""
        data: Dict[str, list] = {
            "p_now": out["p_now"][0, :, 0].tolist(),
            "p_future": out["p_future"][0, :, 0].tolist(),
            "model_vad0": out["vad"][0, :, 0].tolist(),
            "model_vad1": out["vad"][0, :, 1].tolist(),
            "H": out["H"][0].tolist(),
        }
        if "loss" in out:
            data["loss"] = out["loss"][0].tolist()
        return data

    def save_json(self, out: Dict[str, np.ndarray], path: str) -> None:
        write_json(self.get_minimal_output(out), path)

    def save_csv(self, out: Dict[str, np.ndarray], path: str) -> None:
        """One row a frame; the loss column, a label horizon shorter, is
        padded with 0 to the full length, as the reference does."""
        data = self.get_minimal_output(out)
        keys = list(data)
        n_rows = len(data["p_now"])
        cols = [data[k] + [0] * (n_rows - len(data[k])) for k in keys]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(keys)
            for row in zip(*cols):
                w.writerow(row)
