"""Seeded weights on the device, in the program's names and layouts.

The benchmark owns them: the program gets a copy loaded into its modules,
the reference the originals. Every leaf is drawn from one generator on the
device in two calls (one uniform, one normal draw for all leaves), then
scaled leaf by leaf:

* conv weights and biases uniform in +-1/sqrt(kernel * in) (PyTorch's
  default, the reference code's ``nn.Conv1d``); GRU weights uniform in
  +-1/sqrt(hidden) (``nn.GRU``'s default);
* linear weights normal(0, 0.02) (the GPT init the model follows),
  the heads' too, their biases 0;
* norm scales 1 + normal(0, 0.1), shifts normal(0, 0.1), so that they
  matter;
* the CPC prediction heads normal(0, 1/sqrt(ar dim)).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

_HEADS = ("va_classifier.", "vap_head.")


def _rule(name: str, shape: Tuple[int, ...], shapes: Dict[str, Tuple[int, ...]]) -> Tuple[str, float, float]:
    """(distribution, scale, shift) of a leaf."""
    parent, leaf = name.rsplit(".", 1)
    if parent.endswith("conv"):
        k, c_in = shapes[parent + ".w"][:2]
        return "uniform", 1.0 / math.sqrt(k * c_in), 0.0
    if parent.endswith("gAR"):
        return "uniform", 1.0 / math.sqrt(shapes[parent + ".w_hh"][0]), 0.0
    if name == "heads.W":
        return "normal", 1.0 / math.sqrt(shape[1]), 0.0
    if name.startswith(_HEADS):
        return ("normal", 0.02, 0.0) if leaf == "w" else ("zero", 0.0, 0.0)
    if len(shape) == 2:
        return "normal", 0.02, 0.0
    return "normal", 0.1, 1.0 if leaf == "w" else 0.0


def draw(named_shapes: Iterable[Tuple[str, Tuple[int, ...]]], gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every (name, shape)."""
    shapes = {n: tuple(s) for n, s in named_shapes}
    rules = {n: _rule(n, s, shapes) for n, s in shapes.items()}
    counts = {kind: sum(math.prod(shapes[n]) for n, r in rules.items() if r[0] == kind)
              for kind in ("uniform", "normal")}
    pools = {
        "uniform": torch.rand(counts["uniform"], generator=gen, device=device) * 2.0 - 1.0,
        "normal": torch.randn(counts["normal"], generator=gen, device=device),
    }
    used = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape in shapes.items():
        kind, scale, shift = rules[name]
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        out[name] = pools[kind][used[kind]:used[kind] + n].reshape(shape) * scale + shift
        used[kind] += n
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor], prefix: str = "") -> None:
    """Copy the weights into the module's parameters of the same names."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(weights[prefix + name])


def shapes_of(module: torch.nn.Module, prefix: str = ""):
    return [(prefix + n, tuple(p.shape)) for n, p in module.named_parameters()]
