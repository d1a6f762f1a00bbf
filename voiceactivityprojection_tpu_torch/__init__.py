"""voiceactivityprojection_tpu_torch: the PyTorch / CUDA port of
``voiceactivityprojection_tpu``.

The JAX package stays the reference; this package runs the same model on
an NVIDIA H100 (Hopper, ``sm_90a``) with hand-written CUDA kernels where the
JAX package has Pallas kernels. It imports neither JAX nor the JAX package.

    from voiceactivityprojection_tpu_torch import VapConfig, VapModel
    model = VapModel(VapConfig(dtype="bfloat16"))      # device defaults to cuda
    out = model.probs(waveform)                         # (B, 2, n) at 16 kHz
    # out["p_now"], out["p_future"]: (B, T, 2); out["H"]: (B, T)

Weights from the JAX package: ``VapModel.from_jax_params(tree, conf)`` with
``tree = jax.tree.map(np.asarray, params)``.
"""

from voiceactivityprojection_tpu_torch.config import BIN_TIMES, VapConfig
from voiceactivityprojection_tpu_torch.models.checkpoint import params_from_jax
from voiceactivityprojection_tpu_torch.models.vap import VapModel

__all__ = ["BIN_TIMES", "VapConfig", "VapModel", "params_from_jax"]
