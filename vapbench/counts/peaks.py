"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at the full 700 W power limit), by the dtype a configuration
states.

* bfloat16: 989 TFLOP/s, the tensor cores' dense bf16 rate.
* float32: 495 TFLOP/s, the tensor cores' dense TF32 rate. It is the highest
  rate at which any product of float32 inputs runs on the card, so no share
  of it passes 100 % whatever implements the work: plain FFMA tops out at
  67, and a 3xTF32 route (three TF32 products for one float32 product)
  at a third of 495. The 67 TFLOP/s of the CUDA cores is not the bound:
  the port's float32 convolutions and attention run on the tensor cores
  and read over 100 % of it.
* bytes: 3.35 TB/s of HBM3.

A share is the call's least time, the larger of its operations over the
peak and its bytes over the bandwidth, over its measured time.
"""

from __future__ import annotations

from typing import Dict

PEAK_TFLOPS: Dict[str, float] = {"bfloat16": 989.0, "float32": 495.0}
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for this work."""
    return max(flops / (PEAK_TFLOPS[dtype] * 1e12), nbytes / PEAK_BYTES_PER_S)


def share_pct(flops: float, nbytes: float, dtype: str, seconds: float) -> float:
    """Percent of the roofline reached in ``seconds``."""
    return 100.0 * least_seconds(flops, nbytes, dtype) / seconds
