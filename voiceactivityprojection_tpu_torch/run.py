"""Offline VAP inference from a WAV file (JAX: run.py:40-145).

    python -m voiceactivityprojection_tpu_torch.run -a audio.wav [-sd state_dict.pt | --checkpoint DIR]
        [-o out.json] [--vad_list vad.json] [--chunk] [--context_parallel] [--plot]
        [--device cuda|cpu] [--vap_<field> ...]

Loads a stereo WAV (a mono one gets a silent second channel), runs the
model and writes every output as JSON, to ``-o`` or to ``<audio name>.json``
in the working directory. Audio over 160 s, or any audio under
``--chunk``, runs as overlapping windows (``inference/extraction.py``);
``--context_parallel`` runs one exact pass with the time axis split over
every CUDA device (``parallel/context.py``). ``-sd`` takes a reference
state dict (``.pt``) or Lightning checkpoint (``.ckpt``), ``--checkpoint``
a training checkpoint of the port (``ckpt_best`` / ``ckpt_last`` of
``python -m voiceactivityprojection_tpu_torch.train``); without either the
weights are drawn from seed 0, with a warning.

The model runs on the card unless ``--device cpu`` asks for the plain
PyTorch path; without a card the default raises. ``--plot`` writes
``utils/plot.plot_stereo``'s figure beside the JSON (``.png``; it needs
matplotlib, which the card's machine lacks). A ``timings`` JSON line
gives the host-clock seconds of each stage, and a line names the audio
decoder and resampler that ran (``native`` or ``scipy``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from os.path import basename
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.inference.extraction import MAX_SINGLE_SHOT_TIME, VapExtractor
from voiceactivityprojection_tpu_torch.models.vap import VapModel
from voiceactivityprojection_tpu_torch.ops.audio import load_waveform, mono_to_stereo
from voiceactivityprojection_tpu_torch.ops.vad import vad_list_to_onehot
from voiceactivityprojection_tpu_torch.parallel.mesh import Mesh, make_mesh
from voiceactivityprojection_tpu_torch.utils.io import read_json, tensor_dict_to_json, write_json


def get_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="VAP offline inference (PyTorch port)")
    parser.add_argument("-a", "--audio", type=str, required=True, help="wav path")
    parser.add_argument("-sd", "--state_dict", type=str, default="",
                        help="reference state dict (.pt) or Lightning checkpoint (.ckpt)")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="training checkpoint directory of the port (runs/.../ckpt_best): its params")
    parser.add_argument("-o", "--output", type=str, default="",
                        help="output json path (default: <audio name>.json)")
    parser.add_argument("--vad_list", type=str, default="", help="vad_list json: adds the per-frame loss")
    parser.add_argument("--chunk", action="store_true", help="force chunked extraction")
    parser.add_argument("--chunk_time", type=float, default=25.0)
    parser.add_argument("--step_time", type=float, default=5.0)
    parser.add_argument("--context_parallel", action="store_true",
                        help="one exact pass with the time axis split over every CUDA device")
    parser.add_argument("--plot", action="store_true", help="write the summary figure beside the JSON (.png)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu (the plain PyTorch path)")
    VapConfig.add_argparse_args(parser)
    return parser.parse_args(argv)


def extract_waveform(
    model: VapModel,
    waveform: np.ndarray,
    vad: Optional[np.ndarray] = None,
    chunk: bool = False,
    chunk_time: float = 25.0,
    step_time: float = 5.0,
    mesh: Optional[Mesh] = None,
) -> Tuple[Dict[str, np.ndarray], str]:
    """The CLI's extraction of one (1, 2, n) waveform: over ``mesh`` when it
    is given (context parallel; ``vad`` unused, as in the JAX CLI), else
    chunked under ``chunk`` or past 160 s, else single shot. Returns the
    outputs on the host and a line saying which mode ran."""
    if mesh is not None:
        from voiceactivityprojection_tpu_torch.parallel.context import (
            TOTAL_DOWNSAMPLE,
            pad_waveform_for_mesh,
            probs_context_parallel,
        )

        n_dev = mesh.shape["data"]
        t50 = waveform.shape[-1] // TOTAL_DOWNSAMPLE
        wav = pad_waveform_for_mesh(torch.as_tensor(waveform, device=mesh.devices[0]), n_dev)
        out = probs_context_parallel(model.net, wav, model.conf, mesh)
        out = {k: (v[:, :t50] if v.ndim >= 2 else v).cpu().numpy() for k, v in out.items()}
        return out, f"Context-parallel single shot over {n_dev} shards: {out['p_now'].shape[1]} frames"
    extractor = VapExtractor(model, context_time=chunk_time - step_time, step_time=step_time)
    duration = waveform.shape[-1] / model.conf.sample_rate
    if chunk or duration > MAX_SINGLE_SHOT_TIME:
        out = extractor.step_extraction(waveform, vad=vad)
        return out, f"Chunked extraction: {out['p_now'].shape[1]} frames"
    out = extractor.extract(waveform, vad=vad)
    return out, f"Single shot: {out['p_now'].shape[1]} frames"


def main(argv: Optional[List[str]] = None) -> None:
    args = get_args(argv)
    timings = {}
    t0 = time.perf_counter()
    model = VapModel.from_args(args, device=args.device)
    if args.state_dict:
        print(f"Loaded state dict: {args.state_dict}")
    elif args.checkpoint:
        print(f"Restored checkpoint: {args.checkpoint}")
    else:
        print("WARNING: random-init weights (no --state_dict or --checkpoint given)")
    conf = model.conf
    timings["load_weights_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    backends: Dict[str, Optional[str]] = {}
    waveform, sr = load_waveform(args.audio, sample_rate=conf.sample_rate, backends=backends)
    duration = waveform.shape[-1] / sr
    waveform = mono_to_stereo(waveform[None])  # (1, 2, n)
    timings["load_audio_s"] = time.perf_counter() - t0
    print(f"Audio: {args.audio} ({duration:.1f} s, {waveform.shape})")
    print(f"Audio decoder: {backends['decoder']}, resampler: {backends['resampler'] or 'none (same rate)'}")

    vad = None
    if args.vad_list:
        vad = vad_list_to_onehot(read_json(args.vad_list), duration=duration + conf.horizon_time,
                                 frame_hz=conf.frame_hz)[None]

    mesh = None
    if args.context_parallel:
        # one shard per CUDA device, as the JAX CLI takes every device; on
        # the CPU one shard
        mesh = make_mesh() if model.device.type == "cuda" else Mesh([model.device])
    t0 = time.perf_counter()
    out, what = extract_waveform(model, waveform, vad, args.chunk, args.chunk_time, args.step_time, mesh)
    timings["extract_s"] = time.perf_counter() - t0
    print(what)

    t0 = time.perf_counter()
    savepath = args.output or basename(args.audio).replace(".wav", ".json")
    write_json(tensor_dict_to_json(out), savepath)
    timings["write_json_s"] = time.perf_counter() - t0
    print(f"Saved output -> {savepath}")

    if args.plot:
        from voiceactivityprojection_tpu_torch.utils.plot import plot_stereo

        fig_path = savepath.replace(".json", ".png")
        plot_stereo(waveform[0], p_now=out["p_now"][0], p_future=out["p_future"][0], vad=out["vad"][0],
                    savepath=fig_path)
        print(f"Saved figure -> {fig_path}")
    print(json.dumps({"timings": timings, "device": str(model.device), "audio_s": duration}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
