"""Weight, activation and gradient statistics of the model (JAX:
analyzes/model_params_grad.py; reference analyzes/model_params_grad.py:8-161).

    python -m voiceactivityprojection_tpu_torch.analyzes.model_params_grad
        [--state_dict sd.pt] [--audio wav] [--seconds 5]
        [--out model_params_grad.json] [--plot] [--device cuda|cpu] [--vap_<field> ...]

Runs one stereo input (``--audio``, its channel beside a silent one for a
mono file, else seeded noise of ``--seconds``) with a seeded random VAD
through the model on the device (the card unless ``--device cpu``; without
a card the default raises) and writes, by ``utils/profiling.py``: every
weight's statistics (``param/<name>``), the stages' activations
(``activation_stats``: the inference forward) and the multitask loss's
gradients (``gradient_stats``: the training forward at rate 0), each with
mean, std, largest magnitude, share of zeros and a 30-bin histogram.
``--plot`` adds the activations' histograms as a PNG beside the JSON
(matplotlib through ``utils/plot.py``; without it the tool raises).

Weights: ``--state_dict`` (a reference state dict), through
``VapModel.from_args``; without it the port's seed-0 draw, not JAX's
``init_vap`` draw. ``collect``
returns the report.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np

from voiceactivityprojection_tpu_torch.config import VapConfig


def input_batch(conf: VapConfig, audio: str = "", seconds: float = 5.0) -> Dict[str, np.ndarray]:
    """The analyzed waveform (1, 2, n) and a random VAD of its length plus
    the projection horizon (1, frames, 2), from fixed seeds."""
    if audio:
        from voiceactivityprojection_tpu_torch.ops.audio import load_waveform, mono_to_stereo

        w, _ = load_waveform(audio, sample_rate=conf.sample_rate)
        waveform = mono_to_stereo(w[None])
    else:
        n = int(seconds * conf.sample_rate)
        waveform = 0.1 * np.random.default_rng(0).normal(size=(1, 2, n)).astype(np.float32)
    # the VAD length follows the waveform's (an --audio file need not last --seconds)
    frames = waveform.shape[-1] * conf.frame_hz // conf.sample_rate + conf.horizon_frames
    vad = (np.random.default_rng(1).random((1, frames, 2)) < 0.5).astype(np.float32)
    return {"waveform": waveform, "vad": vad}


def collect(model, batch: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """``{"params", "activations", "gradients"}`` statistics of ``model``
    (a stereo ``VapModel``) on ``batch``."""
    from voiceactivityprojection_tpu_torch.utils.profiling import activation_stats, gradient_stats, tree_stats

    return {
        "params": tree_stats(model.net, prefix="param/"),
        "activations": activation_stats(model, batch["waveform"]),
        "gradients": gradient_stats(model, batch),
    }


def plot_activations(report: Dict[str, Dict], path: str) -> None:
    from voiceactivityprojection_tpu_torch.utils.plot import _plt

    plt = _plt()
    acts = report["activations"]
    fig, axes = plt.subplots(1, len(acts), figsize=(4 * len(acts), 3))
    for ax, (name, st) in zip(np.atleast_1d(axes), acts.items()):
        edges = np.array(st["bin_edges"])
        ax.bar(0.5 * (edges[:-1] + edges[1:]), st["hist"], width=np.diff(edges))
        ax.set_title(name, fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="weight, activation and gradient statistics (PyTorch port)")
    parser.add_argument("--state_dict", type=str, default="")
    parser.add_argument("--audio", type=str, default="", help="wav (else noise)")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--out", type=str, default="model_params_grad.json")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    VapConfig.add_argparse_args(parser)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    from voiceactivityprojection_tpu_torch.models.vap import VapModel
    from voiceactivityprojection_tpu_torch.utils.io import write_json

    args = get_parser().parse_args(argv)
    model = VapModel.from_args(args, device=args.device)
    report = collect(model, input_batch(model.conf, args.audio, args.seconds))
    write_json(report, args.out)
    print(f"Saved -> {args.out} ({len(report['params'])} params, {len(report['gradients'])} grads)")
    if args.plot:
        fig_path = args.out.replace(".json", ".png")
        plot_activations(report, fig_path)
        print(f"Saved -> {fig_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
