"""Exact streaming encoder: hop by hop, the batch forward's frames.

Counterpart of ``voiceactivityprojection_tpu/models/encoder_streaming_exact.py``.
The CPC conv stack pads symmetrically, so frame t depends on a few later
samples. This encoder takes that lookahead (about 153 samples) as latency
and reproduces the unfused batch ``apply_encoder`` frames:

* the PRIME push (the first chunk) starts each conv layer from its
  symmetric left padding ``p`` and the downsample from its causal left
  padding of 4;
* every STEADY push starts each layer from the tail the previous push left,
  whose length has converged to a constant, and emits one frame per 320
  samples.

Tail lengths (kernel k, stride s, pad p; chunks a multiple of 320 samples),
from ``_compute_tails``:

  layer        k  s  p   prime-len  steady-len
  conv0       10  5  3       3          8
  conv1        8  4  2       2          5
  conv2..4     4  2  1       1          2
  downsample   5  2  4(L)    4          3

Buffers hold max(prime, steady) columns; each push reads the last
``prime`` or ``steady`` of them. The convs run plain (``ops/conv.py``
``conv1d`` unpadded, ChannelNorm, ReLU), as JAX runs them: a hop is 320
samples a frame, too short for the conv stack kernel. The GRU is
``ops/gru.py`` ``gru`` from the carried hidden state, on the card the
recurrence kernel (K3) with that h0; its last output is the next push's
h0. Frames equal the batch forward's on the CPU (within float32 rounding
of the summation order); on the card the batch forward runs the conv stack
kernel (K1) and the GRU + downsample kernel (K2), which sum in other
orders. ``_run_pipeline`` computes the next state as new tensors; ``push``
copies them into the tensors of the state it read, so the state keeps its
addresses for the encoder's life (a CUDA graph of a steady push replays
against them: ``inference/streaming_kv.py``); ``reset`` and
``reset_rows`` zero them in place.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from voiceactivityprojection_tpu_torch.models.encoder import (
    CPC_CONV_SPECS,
    DOWNSAMPLE_KERNEL,
    DOWNSAMPLE_STRIDE,
    Encoder,
)
from voiceactivityprojection_tpu_torch.ops.conv import channel_norm, conv1d, layer_norm
from voiceactivityprojection_tpu_torch.ops.gru import gru

SAMPLES_PER_FRAME = 320  # 16 kHz / 50 Hz


def _compute_tails() -> Tuple[List[Tuple[int, int]], int, int]:
    """Per conv layer (steady tail, prime tail), and the downsample's prime
    and steady tails: the prime pass of a 320-sample (one-frame) hop,
    chained through the layers (JAX: encoder_streaming_exact.py:59-72)."""
    conv_tails = []
    c = SAMPLES_PER_FRAME
    for k, s, p in CPC_CONV_SPECS:
        o = (p + c - k) // s + 1
        conv_tails.append((p + c - s * o, p))
        c = o
    down_prime = DOWNSAMPLE_KERNEL - 1  # causal left pad 4
    o = (down_prime + c - DOWNSAMPLE_KERNEL) // DOWNSAMPLE_STRIDE + 1
    down_steady = down_prime + c - DOWNSAMPLE_STRIDE * o
    return conv_tails, down_prime, down_steady


_CONV_TAILS, _DOWN_PRIME, _DOWN_STEADY = _compute_tails()


class ExactStreamState(NamedTuple):
    conv_tails: Tuple[torch.Tensor, ...]  # (B, max(steady, prime), C) each
    gru_h: torch.Tensor                   # (B, H), contiguous
    down_tail: torch.Tensor               # (B, max(_DOWN_PRIME, _DOWN_STEADY), C)


def init_exact_state(enc: Encoder, batch: int, dtype: torch.dtype = torch.float32) -> ExactStreamState:
    """Zeroed state on the encoder's device."""
    device = enc.gAR.w_hh.device
    dim = enc.gAR.w_hh.shape[0]
    tails, c_in = [], 1
    for steady, prime in _CONV_TAILS:
        tails.append(torch.zeros(batch, max(steady, prime), c_in, dtype=dtype, device=device))
        c_in = dim
    return ExactStreamState(
        conv_tails=tuple(tails),
        gru_h=torch.zeros(batch, dim, dtype=dtype, device=device),
        down_tail=torch.zeros(batch, max(_DOWN_PRIME, _DOWN_STEADY), dim, dtype=dtype, device=device),
    )


def _repack(buf: torch.Tensor, consumed: int, keep: int) -> torch.Tensor:
    """What ``buf`` leaves after ``consumed`` columns, as a ``keep``-column
    tail: left-padded with zeros (never read again: later pushes read only
    the last ``steady`` columns) or cut to its last ``keep``."""
    left = buf[:, consumed:]
    pad = keep - left.shape[1]
    if pad > 0:
        return F.pad(left, (0, 0, pad, 0))
    return left[:, left.shape[1] - keep:]


def _run_pipeline(
    enc: Encoder, x: torch.Tensor, state: ExactStreamState, prime: bool
) -> Tuple[torch.Tensor, ExactStreamState]:
    """x (B, n, 1) -> (features (B, frames, C), new state)
    (JAX: encoder_streaming_exact.py:95-148)."""
    new_tails = []
    for layer, (k, s, _), tail, (steady, prime_len) in zip(
        enc.gEncoder, CPC_CONV_SPECS, state.conv_tails, _CONV_TAILS
    ):
        use = prime_len if prime else steady
        buf = torch.cat([tail[:, tail.shape[1] - use:], x], dim=1)
        n_out = (buf.shape[1] - k) // s + 1
        new_tails.append(_repack(buf, s * n_out, tail.shape[1]))
        x = conv1d(buf, layer.conv.w, layer.conv.b, stride=s)
        x = torch.relu(channel_norm(x, layer.norm.w, layer.norm.b))

    g, d = enc.gAR, enc.downsample
    z, h = gru(x, g.w_ih, g.w_hh, g.b_ih, g.b_hh, h0=state.gru_h)

    use = _DOWN_PRIME if prime else _DOWN_STEADY
    tail = state.down_tail
    buf = torch.cat([tail[:, tail.shape[1] - use:], z], dim=1)
    n_out = (buf.shape[1] - DOWNSAMPLE_KERNEL) // DOWNSAMPLE_STRIDE + 1
    down_tail = _repack(buf, DOWNSAMPLE_STRIDE * n_out, tail.shape[1])
    y = conv1d(buf, d.conv.w, d.conv.b, stride=DOWNSAMPLE_STRIDE)
    y = F.gelu(layer_norm(y, d.ln.w, d.ln.b))
    return y, ExactStreamState(tuple(new_tails), h, down_tail)


def _tensors(state: ExactStreamState) -> Tuple[torch.Tensor, ...]:
    return (*state.conv_tails, state.gru_h, state.down_tail)


def advance(enc: Encoder, x: torch.Tensor, state: ExactStreamState, prime: bool) -> torch.Tensor:
    """One push's device work: x (B, n, 1) -> features (B, frames, C), with
    the next state copied into ``state``'s tensors (a state that
    ``_run_pipeline`` hands back unchanged stays as it is)."""
    y, new = _run_pipeline(enc, x, state, prime)
    for old, nxt in zip(_tensors(state), _tensors(new)):
        old.copy_(nxt)
    return y


class ExactStreamingEncoder:
    """Stateful wrapper: push chunks (B, n) with n a multiple of 320.

    After the prime push every push returns n/320 frames equal to the batch
    ``apply_encoder`` frames at the same indices (JAX:
    encoder_streaming_exact.py:157-196), on the encoder's device."""

    def __init__(self, enc: Encoder, batch: int = 1, dtype: torch.dtype = torch.float32):
        self.enc = enc
        self.batch = batch
        self.dtype = dtype
        self.device = enc.gAR.w_hh.device
        self.reset()

    @torch.inference_mode()
    def reset(self) -> None:
        """Zeroed state, the next push a prime push; the state's tensors
        keep their addresses once made."""
        if getattr(self, "state", None) is None:
            self.state = init_exact_state(self.enc, self.batch, self.dtype)
        else:
            for t in _tensors(self.state):
                t.zero_()
        self.primed = False
        self.frames_emitted = 0

    @torch.inference_mode()
    def reset_rows(self, rows: Sequence[int]) -> None:
        """Zero the conv tails, GRU hidden and downsample tail of the given
        batch rows, so a recycled serving slot carries nothing of the
        previous dialog's audio. The GRU restarts exactly; the zeroed tails
        act as silence before the new dialog at each layer, and the
        features reach the batch-exact ones once the tails flush (under the
        conv stack's receptive field of about 0.12 s)."""
        idx = torch.as_tensor(list(rows), dtype=torch.long, device=self.device)
        for t in _tensors(self.state):
            t.index_fill_(0, idx, 0.0)

    @torch.inference_mode()
    def push(self, chunk) -> torch.Tensor:
        chunk = torch.as_tensor(chunk, dtype=self.dtype, device=self.device)
        if chunk.ndim != 2 or chunk.shape[1] % SAMPLES_PER_FRAME:
            raise ValueError(f"chunk must be (B, n*{SAMPLES_PER_FRAME}), got {tuple(chunk.shape)}")
        y = advance(self.enc, chunk[..., None], self.state, not self.primed)
        self.primed = True
        self.frames_emitted += y.shape[1]
        return y
