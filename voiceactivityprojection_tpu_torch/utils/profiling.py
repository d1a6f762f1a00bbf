"""Profiling and tensor statistics (JAX: utils/profiling.py).

* ``trace(log_dir)``: a context manager around ``torch.profiler.profile``
  (the CPU, and the card where there is one) that writes a Chrome-format
  trace (``*.pt.trace.json``) into ``log_dir``, which TensorBoard's
  profiler plugin and Perfetto load.
* ``annotate(name)``: a named span in that trace
  (``torch.profiler.record_function``).
* ``tree_stats``, ``activation_stats``, ``gradient_stats``: mean, std,
  largest magnitude, share of zeros and a histogram of every weight,
  activation or gradient (the reference's layer-output and gradient hooks,
  analyzes/model_params_grad.py). Weights are keyed by the JAX package's
  ``/``-joined names (``ar/layers/0/mha/query/w``), which the port's
  module names follow one to one (``models/checkpoint.py``
  ``params_from_jax``); the ALiBi slopes ``m`` are buffers here and
  leaves there, and are counted with the weights.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block: ``with trace("dir"): run_step()``. The
    default directory is ``vap_trace`` in the temporary directory. On the
    card the device is synchronized before the profiler starts and again
    before it stops, so that the trace holds exactly the block's kernels,
    each finished and recorded before the profiler collects. A process that
    has already run many profiler sessions (about 16-20 of some 55,000
    events each on an H100) can lose kernel records in PyTorch's profiler
    itself, the synchronize notwithstanding (``tools/trace_sessions.py``):
    take a trace that must be whole in a fresh process."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "vap_trace")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if cuda:
            torch.cuda.synchronize()


def annotate(name: str):
    return torch.profiler.record_function(name)


def _leaf_stats(x, bins: int) -> Dict[str, Any]:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    x = np.asarray(x, dtype=np.float64).ravel()
    hist, edges = np.histogram(x, bins=bins)
    return {
        "mean": float(x.mean()),
        "std": float(x.std()),
        "absmax": float(np.abs(x).max()),
        "frac_zero": float((x == 0).mean()),
        "hist": hist.tolist(),
        "bin_edges": edges.tolist(),
    }


def _named(tree: Any, prefix: str = ""):
    """(name, tensor) pairs of a module (its weights and buffers), or of a
    nested dict / list of tensors or arrays, the names ``/``-joined."""
    if isinstance(tree, torch.nn.Module):
        for name, t in list(tree.named_parameters()) + list(tree.named_buffers()):
            yield prefix + name.replace(".", "/"), t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_stats(tree: Any, bins: int = 30, prefix: str = "") -> Dict[str, Dict]:
    """Statistics of every weight, activation or gradient of ``tree`` (a
    module, or a nested dict / list of tensors or arrays), by name."""
    return {name: _leaf_stats(t, bins) for name, t in _named(tree, prefix)}


def activation_stats(model, waveform, layer_outputs: bool = True, bins: int = 30) -> Dict[str, Dict]:
    """The stereo ``model``'s (a ``VapModel``) stages on ``waveform`` (B, 2,
    n), on its device: the encoder features of each channel, the channel
    GPT's outputs, the stereo GPT's output and the logits."""
    from voiceactivityprojection_tpu_torch.models.encoder import apply_encoder
    from voiceactivityprojection_tpu_torch.models.transformer import apply_gpt, apply_gpt_stereo

    conf, net = model.conf, model.net
    with torch.inference_mode():
        w = model._input(waveform)
        B = w.shape[0]
        z = apply_encoder(net.encoder, w.reshape(B * 2, w.shape[-1])).reshape(B, 2, -1, conf.dim)
        x1, x2 = z[:, 0], z[:, 1]
        acts = {"encoder_x1": x1, "encoder_x2": x2}
        o1 = apply_gpt(net.ar_channel, x1, num_heads=conf.num_heads)["x"]
        o2 = apply_gpt(net.ar_channel, x2, num_heads=conf.num_heads)["x"]
        acts["ar_channel_x1"], acts["ar_channel_x2"] = o1, o2
        out = apply_gpt_stereo(net.ar, o1, o2, num_heads=conf.num_heads)
        acts["ar_x"] = out["x"]
        acts["logits"] = out["x"] @ net.vap_head.w.T + net.vap_head.b
        return {k: _leaf_stats(v, bins) for k, v in acts.items()}


def gradient_stats(model, batch: Dict[str, Any], bins: int = 30) -> Dict[str, Dict]:
    """Statistics of the multitask loss's gradient (``train/step.loss_fn``,
    no dropout) with respect to every weight of the stereo ``model``, keyed
    ``grad/<name>``; a weight that takes no gradient (the frozen encoder,
    the slopes) counts as zeros, as JAX's gradient of it is. The loss runs
    the training forward at rate 0: the inference forward's GRU +
    downsample kernel has no backward. The model's weights and gradients
    are left as they were."""
    import dataclasses

    from voiceactivityprojection_tpu_torch.train.step import loss_fn

    net = model.net
    tensors = {k: model._input(v) for k, v in batch.items()}
    saved = {n: p.grad for n, p in net.named_parameters()}
    try:
        for p in net.parameters():
            p.grad = None
        with torch.enable_grad():
            loss, _ = loss_fn(net, tensors, dataclasses.replace(model.conf, dropout=0.0), torch.Generator())
            loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in net.named_parameters()}
        grads.update({n: torch.zeros_like(b) for n, b in net.named_buffers()})
        return {"grad/" + n.replace(".", "/"): _leaf_stats(g, bins) for n, g in grads.items()}
    finally:
        for n, p in net.named_parameters():
            p.grad = saved[n]
