"""Stereo-output browser over a manifest's windows (JAX:
analyzes/interface_stereo.py; reference analyzes/interface_stereo.py:1-113).

    python -m voiceactivityprojection_tpu_torch.analyzes.interface_stereo --manifest data.csv
        --export DIR [--limit 5] [--state_dict sd.pt | --checkpoint DIR] [--audio_duration 20]
        [--device cuda|cpu] [--vap_<field> ...]
    streamlit run voiceactivityprojection_tpu_torch/analyzes/interface_stereo.py -- --manifest data.csv

``--export DIR`` writes, for each of the first ``--limit`` windows
(``data/dataset.py`` ``SlidingWindowDataset``), the stereo summary figure
(``utils/plot.py`` ``plot_stereo``: each channel's mel spectrogram with the
model's VAD, p_now and p_future) as ``window_NNNN.png``. The model runs
on the card unless ``--device cpu`` (without a card the default raises);
matplotlib draws on the host, and without it the export raises.
Without ``--export`` the streamlit browser runs (``run_streamlit``, which
imports streamlit): neither this package's tests nor its smoke run have
streamlit, so that mode is untested. ``run_export`` returns the PNG paths.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from voiceactivityprojection_tpu_torch.config import VapConfig


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="stereo-output browser and PNG export (PyTorch port)")
    parser.add_argument("--manifest", type=str, required=True)
    parser.add_argument("--state_dict", type=str, default="")
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--audio_duration", type=float, default=20.0)
    parser.add_argument("--export", type=str, default="", help="PNG export dir")
    parser.add_argument("--limit", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    VapConfig.add_argparse_args(parser)
    return parser


def load_model(args):
    from voiceactivityprojection_tpu_torch.models.vap import VapModel

    return VapModel.from_args(args, device=args.device)


def sample_figure(model, item):
    """The stereo figure of one window, and its axes."""
    from voiceactivityprojection_tpu_torch.utils.plot import plot_stereo

    out = model.probs(item["waveform"][None])
    return plot_stereo(item["waveform"], p_now=out["p_now"][0].cpu().numpy(),
                       p_future=out["p_future"][0].cpu().numpy(), vad=out["vad"][0].cpu().numpy())


def run_streamlit(args) -> None:
    import streamlit as st

    from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset

    st.title("VAP stereo browser")
    model = load_model(args)
    ds = SlidingWindowDataset(args.manifest, audio_duration=args.audio_duration)
    idx = st.slider("window", 0, max(len(ds) - 1, 0), 0)
    item = ds[idx]
    st.text(f"{item['session']}")
    fig, _ = sample_figure(model, item)
    st.pyplot(fig)


def run_export(args) -> List[str]:
    from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset
    from voiceactivityprojection_tpu_torch.utils.plot import _plt

    model = load_model(args)
    ds = SlidingWindowDataset(args.manifest, audio_duration=args.audio_duration)
    os.makedirs(args.export, exist_ok=True)
    paths = []
    for i in range(min(len(ds), args.limit)):
        fig, _ = sample_figure(model, ds[i])
        path = os.path.join(args.export, f"window_{i:04d}.png")
        fig.savefig(path, dpi=100)
        _plt().close(fig)
        print(f"Saved -> {path}")
        paths.append(path)
    return paths


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    if args.export:
        run_export(args)
        return 0
    try:  # the availability probe only: a missing import inside run_streamlit shows as itself
        import streamlit  # noqa: F401
    except ImportError:
        print("streamlit not installed; use --export DIR for PNG mode")
        return 1
    run_streamlit(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
