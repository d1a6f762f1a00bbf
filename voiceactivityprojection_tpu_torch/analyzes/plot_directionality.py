"""Forest plot of the phrases directionality results (JAX:
analyzes/plot_directionality.py): the paired mean difference in shift
probability against each sample's regular rendition with its 95 %
bootstrap CI, the predictive region beside the reactive one, every voice
(filled) against the held-out voices (hollow).

    python -m voiceactivityprojection_tpu_torch.analyzes.plot_directionality
        [--dir DIR] [--out DIR/directionality_forest.png] [--device cuda|cpu]

Reads ``directionality.json`` and ``directionality_heldout.json`` (the
``phrases_directionality`` reports under ``--voices all`` and ``heldout``)
from ``--dir``. matplotlib is imported when the figure is drawn
(``utils/plot.py`` ``_plt``): without it the tool raises. The figure is
drawn on the host; ``--device`` is resolved as every entry point's (the
card by default: without one it raises). ``plot_forest`` returns the
path written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from voiceactivityprojection_tpu_torch.utils.device import resolve_device

# one hue for the series, ink and surface tokens for the rest
BLUE = "#2a78d6"
INK = "#0b0b0b"
INK2 = "#52514e"
SURFACE = "#fcfcfb"
GRID = "#d9d8d4"

PERMS = [
    ("flat_f0", "flat F0"),
    ("flat_intensity", "flat intensity"),
    ("duration_avg", "duration avg"),
    ("shift_f0_up", "shift F0 ×1.1"),
    ("shift_f0_down", "shift F0 ×0.9"),
    ("only_f0", "only F0 (low-pass)"),
]
REGIONS = [("now_pred", "predictive region (pre-EOT)"), ("now_react", "reactive region (post-EOT)")]


def plot_forest(result_dir: str, out: str = "") -> str:
    """Draws the forest plot of ``result_dir``'s two reports; returns the
    PNG's path (``out``, else ``directionality_forest.png`` there)."""
    from voiceactivityprojection_tpu_torch.utils.plot import _plt

    plt = _plt()
    from matplotlib.lines import Line2D

    with open(os.path.join(result_dir, "directionality.json")) as f:
        full = json.load(f)["regions"]
    with open(os.path.join(result_dir, "directionality_heldout.json")) as f:
        held = json.load(f)["regions"]

    fig, axes = plt.subplots(1, 2, figsize=(9.2, 3.6), sharey=True, facecolor=SURFACE)
    ys = range(len(PERMS), 0, -1)
    for ax, (region, rtitle) in zip(axes, REGIONS):
        ax.set_facecolor(SURFACE)
        ax.axvline(0, color=INK2, lw=1, zorder=1)
        for y, (perm, _) in zip(ys, PERMS):
            for src, dy, filled in ((full, 0.16, True), (held, -0.16, False)):
                r = src[perm][region]
                lo, hi = r["ci95"]
                ax.plot([lo, hi], [y + dy] * 2, color=BLUE, lw=2, solid_capstyle="round", zorder=2)
                ax.plot([r["mean"]], [y + dy], marker="o", ms=7, zorder=3,
                        markerfacecolor=BLUE if filled else SURFACE, markeredgecolor=BLUE, markeredgewidth=1.6)
        ax.set_title(rtitle, fontsize=10, color=INK, pad=8)
        ax.set_xlabel("paired Δ shift probability vs regular", fontsize=8.5, color=INK2)
        ax.grid(axis="x", color=GRID, lw=0.6, zorder=0)
        for s in ("top", "right", "left"):
            ax.spines[s].set_visible(False)
        ax.spines["bottom"].set_color(GRID)
        ax.tick_params(colors=INK2, labelsize=8.5)
    axes[0].set_yticks(list(ys))
    axes[0].set_yticklabels([label for _, label in PERMS], fontsize=9, color=INK)
    fig.suptitle("Flattening turn-final prosody depresses shift probability — before the end of turn too",
                 fontsize=11, color=INK, x=0.02, ha="left")
    fig.legend(
        handles=[
            Line2D([], [], marker="o", color=BLUE, ls="-", lw=2, ms=7, markerfacecolor=BLUE,
                   label="all voices (n=180)"),
            Line2D([], [], marker="o", color=BLUE, ls="-", lw=2, ms=7, markerfacecolor=SURFACE,
                   markeredgewidth=1.6, label="held-out voices (n=36)"),
        ],
        loc="upper right", frameon=False, fontsize=8.5, labelcolor=INK2, bbox_to_anchor=(0.99, 1.0),
    )
    fig.tight_layout(rect=(0, 0, 1, 0.90))
    out = out or os.path.join(result_dir, "directionality_forest.png")
    fig.savefig(out, dpi=150, facecolor=SURFACE)
    plt.close(fig)
    print(f"saved {out}")
    return out


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="forest plot of the directionality reports (PyTorch port)")
    ap.add_argument("--dir", default="analyzes/results_phrases_r4")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    resolve_device(args.device)
    plot_forest(args.dir, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
