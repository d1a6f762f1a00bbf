"""Phrases browser (JAX: analyzes/interface_stereo_phrases.py; reference
analyzes/interface_stereo_phrases.py:1-101): a phrase sample of the corpus
(padded as the probe pads it), optionally under a prosodic permutation,
through the model, drawn as the stereo summary figure.

    python -m voiceactivityprojection_tpu_torch.analyzes.interface_stereo_phrases --export DIR
        [--limit 4] [--permutation regular|flat_f0|...] [--phrases_root ROOT]
        [--state_dict sd.pt | --checkpoint DIR] [--device cuda|cpu] [--vap_<field> ...]
    streamlit run voiceactivityprojection_tpu_torch/analyzes/interface_stereo_phrases.py -- [--phrases_root ROOT]

``--export DIR`` writes the figure of each of the first ``--limit``
samples (``data/phrases.py`` ``PhraseDataset``) under ``--permutation``
(``evaluate_phrases.permute_waveform`` on the active channel, the port's
``ops/prosody.py``) as ``<phrase>_<long_short>_<gender>_<idx>_<perm>.png``.
The model runs on the card unless ``--device cpu`` (without a card the
default raises); matplotlib draws on the host, and without it the export
raises. Without ``--export`` the streamlit browser runs (``run_streamlit``,
which imports streamlit): neither this package's tests nor its smoke run
have streamlit, so that mode is untested. ``run_export`` returns the PNG
paths.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.data.phrases import DEFAULT_PHRASES_ROOT
from voiceactivityprojection_tpu_torch.evaluate_phrases import PERMUTATIONS


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="phrases browser and PNG export (PyTorch port)")
    parser.add_argument("--state_dict", type=str, default="")
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--phrases_root", type=str, default=DEFAULT_PHRASES_ROOT)
    parser.add_argument("--export", type=str, default="", help="PNG export dir")
    parser.add_argument("--limit", type=int, default=4)
    parser.add_argument("--permutation", type=str, default="regular", choices=PERMUTATIONS)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    VapConfig.add_argparse_args(parser)
    return parser


def get_args(argv: Optional[List[str]] = None):
    # streamlit passes its own argv after `--`: unknown flags are tolerated
    args, _ = get_parser().parse_known_args(argv)
    return args


def permuted(item, permutation: str) -> np.ndarray:
    """The sample's (2, n) waveform with its active channel permuted, cut or
    zero-padded to its length."""
    if permutation == "regular":
        return item["waveform"]
    from voiceactivityprojection_tpu_torch.evaluate_phrases import permute_waveform

    out = np.array(item["waveform"])
    y = permute_waveform(permutation, np.asarray(out[0], np.float64), item).astype(np.float32)
    n = min(len(y), out.shape[-1])
    out[0, :n] = y[:n]
    out[0, n:] = 0.0
    return out


def sample_figure(model, item, permutation: str):
    from voiceactivityprojection_tpu_torch.utils.plot import plot_stereo

    w = permuted(item, permutation)
    out = model.probs(w[None])
    fig, _ = plot_stereo(w, p_now=out["p_now"][0].cpu().numpy(), p_future=out["p_future"][0].cpu().numpy(),
                         vad=out["vad"][0].cpu().numpy())
    return fig


def run_streamlit(args) -> None:
    import streamlit as st

    from voiceactivityprojection_tpu_torch.data.phrases import PhraseDataset
    from voiceactivityprojection_tpu_torch.models.vap import VapModel

    st.title("VAP Phrases")
    model = VapModel.from_args(args, device=args.device)
    ds = PhraseDataset(root=args.phrases_root)
    c1, c2, c3, c4, c5 = st.columns([2, 1, 1, 1, 2])
    phrase = c1.selectbox("phrase", sorted({r["phrase"] for r in ds.rows}))
    longshort = c2.selectbox("length", ["short", "long"])
    gender = c3.selectbox("gender", ["female", "male"])
    # the voices of the selected combination: another corpus may lack some
    voices = sorted({r["phrase_idx"] for r in ds.rows
                     if (r["phrase"], r["long_short"], r["gender"]) == (phrase, longshort, gender)})
    if not voices:
        st.warning(f"no samples for {phrase}/{longshort}/{gender} in this corpus")
        st.stop()
    idx = c4.selectbox("voice idx", voices)
    permutation = c5.selectbox("permutation", list(PERMUTATIONS))
    item = ds.get_sample(phrase, longshort, gender, int(idx))
    st.text(os.path.basename(item["audio_path"]))
    st.pyplot(sample_figure(model, item, permutation))


def run_export(args) -> List[str]:
    from voiceactivityprojection_tpu_torch.data.phrases import PhraseDataset
    from voiceactivityprojection_tpu_torch.models.vap import VapModel
    from voiceactivityprojection_tpu_torch.utils.plot import _plt

    model = VapModel.from_args(args, device=args.device)
    ds = PhraseDataset(root=args.phrases_root)
    os.makedirs(args.export, exist_ok=True)
    paths = []
    for i in range(min(len(ds), args.limit)):
        item = ds[i]
        fig = sample_figure(model, item, args.permutation)
        name = f"{item['phrase']}_{item['long_short']}_{item['gender']}_{item['phrase_idx']}_{args.permutation}.png"
        path = os.path.join(args.export, name)
        fig.savefig(path, dpi=100)
        _plt().close(fig)
        print(f"saved {name}")
        paths.append(path)
    return paths


def main(argv: Optional[List[str]] = None) -> int:
    args = get_args(argv)
    if args.export:
        run_export(args)
        return 0
    try:  # the availability probe only: a missing import inside run_streamlit shows as itself
        import streamlit  # noqa: F401
    except ImportError:
        print("streamlit not installed; use --export DIR for PNGs")
        return 1
    run_streamlit(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
