"""Weights from the JAX package's params pytree.

The port's parameter names are the JAX pytree paths joined by dots (list
positions become indices), and its layouts are the JAX layouts, so the
map is one to one. ``params_from_jax`` takes the tree as nested
dicts/lists of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the state dict that ``VapNet.load_state_dict`` takes; it raises
on a leaf the port does not use, on a weight it did not fill and on a
shape that differs.

``encoder_from_jax`` and ``cpc_heads_from_jax`` do the same for the JAX
``init_encoder`` and ``init_cpc_heads`` trees and return the port's
modules. ``random_params_tree`` makes a params tree from a seed, with the
JAX package's initialisation scales, for runs that need weights but no
checkpoint.

CPC blobs (JAX: checkpoint.py:153-298): ``load_cpc_blob`` reads the
libri-light on-disk format (``{"config": ..., "weights": ...}``) with the
JAX package's guard rails, ``import_cpc_checkpoint`` maps its weights, and
``export_cpc_blob`` writes an encoder in that format, all host-side. The
port's side of each is the encoder's state dict (``gEncoder.{i}.conv.w``,
``gAR.w_ih``, ...; JAX layouts). Reference torch state dicts
(``import_vap_state_dict``, ``remap_legacy_state_dict``) come with a later
slice.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from voiceactivityprojection_tpu_torch.config import VapConfig, VapMonoConfig
from voiceactivityprojection_tpu_torch.models.encoder import CPC_CONV_SPECS, Encoder
from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes
from voiceactivityprojection_tpu_torch.ops.params import ParamGroup


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
    from voiceactivityprojection_tpu_torch.models.vap import VapMonoNet, VapNet

    with torch.device("meta"):
        net = (VapMonoNet if isinstance(conf, VapMonoConfig) else VapNet)(conf)
    return {name: t.shape for name, t in net.state_dict().items()}


def _state_from_tree(
    tree: Any, expected: Mapping[str, torch.Size], what: str
) -> Dict[str, torch.Tensor]:
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    unused = sorted(set(flat) - set(expected))
    if unused:
        raise ValueError(f"{what}: leaves the port does not use: {unused}")
    missing = sorted(set(expected) - set(flat))
    if missing:
        raise ValueError(f"{what}: weights the tree does not fill: {missing}")
    state = {}
    for name, shape in expected.items():
        value = flat[name]
        if value.shape != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {value.shape}, expected {tuple(shape)}")
        state[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def params_from_jax(tree: Any, conf: Optional[VapConfig] = None) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> the port's float32 state dict: the
    stereo ``init_vap`` tree, or under a ``VapMonoConfig`` the mono
    ``init_vap_mono`` tree."""
    return _state_from_tree(tree, _expected_shapes(conf or VapConfig()), "params_from_jax")


def _load(module: torch.nn.Module, tree: Any, what: str) -> torch.nn.Module:
    shapes = {name: t.shape for name, t in module.state_dict().items()}
    module.load_state_dict(_state_from_tree(tree, shapes, what))
    return module


def encoder_from_jax(tree: Any) -> Encoder:
    """JAX ``init_encoder`` tree (numpy leaves) -> the port's float32
    ``Encoder`` on the CPU; the width is read from ``gAR.w_hh``."""
    return _load(Encoder(int(np.shape(tree["gAR"]["w_hh"])[0])), tree, "encoder_from_jax")


def cpc_heads_from_jax(tree: Any) -> ParamGroup:
    """JAX ``init_cpc_heads`` tree ``{"W": (K, ar_dim, enc_dim)}`` -> the
    port's float32 heads on the CPU."""
    return _load(ParamGroup(W=tuple(np.shape(tree["W"]))), tree, "cpc_heads_from_jax")


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


# ------------------------------------------------------------------ CPC blobs
# architecture fields of the CPC argparse-namespace config and their
# defaults (JAX: checkpoint.py:181-196). The libri-light blob is
# {"config": vars(namespace), "weights": CPCModel state dict}.
CPC_ARCH_DEFAULTS: Dict[str, Any] = {
    "hiddenEncoder": 256,
    "hiddenGar": 256,
    "arMode": "LSTM",      # the real 60k blob's config selects "GRU"
    "nLevelsGRU": 1,
    "normMode": "layerNorm",
    "encoder_type": "cpc",
    "cpc_mode": None,      # "reverse" flips the sequence (CPCAR.forward)
    "samplingType": "samespeaker",  # "sequential" => keepHidden=True
}


def _f32(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def import_cpc_checkpoint(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Raw CPC checkpoint (the ``weights`` of a libri-light blob) -> the
    port's encoder state without the downsample (JAX: checkpoint.py:153-178):
    conv weights (O, I, K) -> (K, I, O), norms (1, C, 1) -> (C,), GRU
    weights (3H, *) -> (*, 3H)."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(CPC_CONV_SPECS)):
        out[f"gEncoder.{i}.conv.w"] = _f32(np.asarray(sd[f"gEncoder.conv{i}.weight"]).transpose(2, 1, 0))
        out[f"gEncoder.{i}.conv.b"] = _f32(sd[f"gEncoder.conv{i}.bias"])
        out[f"gEncoder.{i}.norm.w"] = _f32(np.asarray(sd[f"gEncoder.batchNorm{i}.weight"]).reshape(-1))
        out[f"gEncoder.{i}.norm.b"] = _f32(np.asarray(sd[f"gEncoder.batchNorm{i}.bias"]).reshape(-1))
    for port_name, name in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0")):
        out[f"gAR.{port_name}"] = _f32(np.asarray(sd[f"gAR.baseNet.{name}"]).T)
    for port_name, name in (("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
        out[f"gAR.{port_name}"] = _f32(sd[f"gAR.baseNet.{name}"])
    return out


def load_cpc_blob(path: str) -> Dict[str, torch.Tensor]:
    """``load_CPC``-equivalent import of a libri-light-format CPC blob (JAX:
    checkpoint.py:199-252): the config is applied over
    ``CPC_ARCH_DEFAULTS``, architectures the VAP encoder cannot hold are
    refused, and extra weights (the CPC prediction network) are ignored.
    Returns the encoder state without the downsample, for
    ``Encoder.load_state_dict(..., strict=False)`` or a VAP state dict under
    ``encoder.``."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(blob, dict) or "weights" not in blob:
        raise ValueError(f"{path}: not a CPC checkpoint blob "
                         "(expected {'config': ..., 'weights': ...})")
    cfg = dict(CPC_ARCH_DEFAULTS)
    cfg.update(blob.get("config", {}))
    if cfg["arMode"] not in ("GRU",):
        raise ValueError(
            f"CPC blob arMode={cfg['arMode']!r}: only the GRU autoregressive "
            "network is supported (the libri-light 60k blob selects GRU)"
        )
    if cfg["encoder_type"] != "cpc" or cfg["normMode"] != "layerNorm":
        raise ValueError(
            f"unsupported CPC encoder_type={cfg['encoder_type']!r} / "
            f"normMode={cfg['normMode']!r} (expected cpc / layerNorm)"
        )
    if int(cfg["nLevelsGRU"]) != 1:
        raise ValueError(f"nLevelsGRU={cfg['nLevelsGRU']}: only 1 supported")
    if cfg["cpc_mode"] == "reverse":
        raise ValueError("cpc_mode='reverse' (flipped sequences) not supported")
    if cfg["samplingType"] == "sequential":
        # keepHidden carries GRU state across forwards; the VAP forward
        # starts every call from h0 = 0
        raise ValueError("samplingType='sequential' (keepHidden) not supported")
    if int(cfg["hiddenEncoder"]) != 256 or int(cfg["hiddenGar"]) != 256:
        raise ValueError(
            f"hiddenEncoder={cfg['hiddenEncoder']} hiddenGar={cfg['hiddenGar']}"
            " do not match the VAP encoder contract (256/256)"
        )
    weights = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
               for k, v in blob["weights"].items()}
    return import_cpc_checkpoint(weights)


def export_cpc_blob(encoder: Union[torch.nn.Module, Mapping[str, torch.Tensor]], path: str) -> None:
    """Inverse of ``load_cpc_blob`` (JAX: checkpoint.py:255-298): write an
    ``Encoder`` (or its state dict; the downsample is left out) as a
    libri-light-format blob, so an encoder pretrained in the port loads in
    the JAX package and in the reference's ``load_CPC``."""
    sd = encoder.state_dict() if isinstance(encoder, torch.nn.Module) else encoder
    w = lambda name: sd[name].detach().cpu()
    weights: Dict[str, torch.Tensor] = {}
    for i in range(len(CPC_CONV_SPECS)):
        weights[f"gEncoder.conv{i}.weight"] = w(f"gEncoder.{i}.conv.w").permute(2, 1, 0).contiguous()
        weights[f"gEncoder.conv{i}.bias"] = w(f"gEncoder.{i}.conv.b").clone()
        weights[f"gEncoder.batchNorm{i}.weight"] = w(f"gEncoder.{i}.norm.w").reshape(1, -1, 1).clone()
        weights[f"gEncoder.batchNorm{i}.bias"] = w(f"gEncoder.{i}.norm.b").reshape(1, -1, 1).clone()
    weights["gAR.baseNet.weight_ih_l0"] = w("gAR.w_ih").T.contiguous()
    weights["gAR.baseNet.weight_hh_l0"] = w("gAR.w_hh").T.contiguous()
    weights["gAR.baseNet.bias_ih_l0"] = w("gAR.b_ih").clone()
    weights["gAR.baseNet.bias_hh_l0"] = w("gAR.b_hh").clone()
    dim = int(sd["gAR.w_hh"].shape[0])
    config = dict(CPC_ARCH_DEFAULTS, arMode="GRU", hiddenEncoder=dim, hiddenGar=dim)
    torch.save({"config": config, "weights": weights}, path)
