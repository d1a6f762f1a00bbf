"""Weights from the JAX package's params pytree.

The port's parameter names are the JAX pytree paths joined by dots (list
positions become indices), and its layouts are the JAX layouts, so the
map is one to one. ``params_from_jax`` takes the tree as nested
dicts/lists of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the state dict that ``VapNet.load_state_dict`` takes; it raises
on a leaf the port does not use, on a weight it did not fill and on a
shape that differs.

``random_params_tree`` makes such a tree from a seed, with the JAX
package's initialisation scales, for runs that need weights but no
checkpoint. Checkpoint I/O (torch state dicts, CPC blobs) comes with a
later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.config import VapConfig
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, Mapping):
        for key, value in tree.items():
            _flatten(value, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            _flatten(value, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def _expected_shapes(conf: VapConfig) -> Dict[str, torch.Size]:
    from voiceactivityprojection_tpu_torch.models.vap import VapNet

    with torch.device("meta"):
        net = VapNet(conf)
    return {name: t.shape for name, t in net.state_dict().items()}


def params_from_jax(tree: Any, conf: Optional[VapConfig] = None) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> the port's float32 state dict."""
    conf = conf or VapConfig()
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    expected = _expected_shapes(conf)
    unused = sorted(set(flat) - set(expected))
    if unused:
        raise ValueError(f"params_from_jax: leaves the port does not use: {unused}")
    missing = sorted(set(expected) - set(flat))
    if missing:
        raise ValueError(f"params_from_jax: weights the tree does not fill: {missing}")
    state = {}
    for name, shape in expected.items():
        value = flat[name]
        if value.shape != tuple(shape):
            raise ValueError(
                f"params_from_jax: {name} has shape {value.shape}, expected {tuple(shape)}"
            )
        state[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def random_params_tree(conf: Optional[VapConfig] = None, seed: int = 0) -> Dict[str, Any]:
    """A params tree in the JAX layout drawn from ``seed``: conv and GRU
    weights uniform in +-1/sqrt(fan_in) (torch's defaults, as the JAX
    ``init_conv1d``/``init_gru``), linear weights normal(0, 0.02), norm
    scales near 1 and shifts near 0 (perturbed, so that they matter),
    ALiBi slopes exact."""
    conf = conf or VapConfig()
    rng = np.random.default_rng(seed)
    flat: Dict[str, np.ndarray] = {}
    for name, shape in _expected_shapes(conf).items():
        shape = tuple(shape)
        parent, leaf = name.rsplit(".", 1)
        if leaf == "m":
            value = alibi_slopes(shape[0]).numpy()
        elif parent.endswith("conv"):
            w_shape = flat.get(f"{parent}.w", np.zeros(shape)).shape if leaf == "b" else shape
            bound = 1.0 / np.sqrt(w_shape[0] * w_shape[1])
            value = rng.uniform(-bound, bound, shape)
        elif parent.endswith("gAR"):
            bound = 1.0 / np.sqrt(conf.encoder_dim)
            value = rng.uniform(-bound, bound, shape)
        elif len(shape) == 2:
            value = 0.02 * rng.standard_normal(shape)
        elif parent in ("va_classifier", "vap_head"):
            value = np.zeros(shape)
        else:  # norm scale (w) and shift (b)
            value = (1.0 if leaf == "w" else 0.0) + 0.1 * rng.standard_normal(shape)
        flat[name] = value.astype(np.float32)
    return _unflatten(flat)
