"""What the entries share: the stereo model built from a configuration and
seeded weights, and the comparison's arithmetic."""

from __future__ import annotations

import gc
import math
import statistics
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from vapbench import weights

STREAM_WEIGHTS, STREAM_INPUTS = 1, 2  # seed paths of the weights and the inputs


def vap_model(ctx):
    """(VapConfig, VapNet on the device with the benchmark's weights, the
    weights the benchmark keeps)."""
    from voiceactivityprojection_tpu_torch.config import VapConfig
    from voiceactivityprojection_tpu_torch.models.vap import VapNet

    conf = VapConfig(**ctx.config["model"])
    net = VapNet(conf).to(ctx.device)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.word(STREAM_WEIGHTS))
    w = weights.draw(weights.shapes_of(net), gen, ctx.device)
    weights.load_into(net, w)
    ctx.note("model built")
    return conf, net, w


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def max_abs(pairs: Iterable[Tuple[np.ndarray, np.ndarray]]) -> float:
    return max(float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))) for a, b in pairs)


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor], leaves: List[str],
             which: str = "worst") -> float:
    """The gap between the program's norm of a leaf and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger: of the worst leaf, or of the median leaf (``which``)."""
    gaps = [g for _, g in worst_leaves(program, reference, leaves, len(leaves))]
    return gaps[0] if which == "worst" else statistics.median(gaps)


def worst_leaves(program, reference, leaves: List[str], n: int = 3) -> List[Tuple[str, float]]:
    """The ``n`` leaves with the largest gaps (``leaf_gap``'s measure); a
    leaf the program has no value for (never moved) has the norm 0."""
    ref = {k: float(reference[k].double().norm()) for k in leaves}
    floor = statistics.median(ref.values())
    got = {k: float(program[k].double().norm()) if k in program else 0.0 for k in leaves}
    gaps = {k: abs(got[k] - ref[k]) / max(ref[k], floor) for k in leaves}
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def moving_leaves(grads: Dict[str, torch.Tensor], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is above ``share`` of the median
    leaf's: the others (a key's bias under softmax) move under Adam by
    round-off alone."""
    norms = {n: float(g.double().norm()) for n, g in grads.items()}
    floor = share * statistics.median(norms.values())
    return sorted(n for n, v in norms.items() if v > floor)


def loss_gap(program: List[float], reference: List[float]) -> float:
    return max(abs(p - r) / abs(r) if r else math.inf for p, r in zip(program, reference))
