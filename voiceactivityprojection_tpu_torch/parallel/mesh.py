"""The device mesh of context parallelism: one axis, ``"data"``.

Counterpart of ``voiceactivityprojection_tpu/parallel/mesh.py`` ``make_mesh``
(:24-33) for what ``parallel/context.py`` needs. One controller drives every
shard, in order, as ``jax.shard_map`` drives a mesh from one program: the
mesh is the sequence of devices its shards run on. A device may repeat:
``make_mesh(n_data=4, devices=[torch.device("cuda")] * 4)`` runs four
shards on one card, and ``[torch.device("cpu")] * 4`` on the CPU (a JAX
mesh takes distinct devices; its tests force several host devices
instead). Tensor parallelism (the JAX mesh's ``"model"`` axis) and data
parallelism over processes are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from voiceactivityprojection_tpu_torch.utils.device import resolve_device

Device = Union[str, torch.device]


def _indexed(device: Device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Devices of the ``"data"`` axis, one per shard, in shard order."""

    def __init__(self, devices: Sequence[Device]):
        self.devices: Tuple[torch.device, ...] = tuple(_indexed(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}


def make_mesh(
    n_data: Optional[int] = None, n_model: int = 1, devices: Optional[Sequence[Device]] = None
) -> Mesh:
    """The first ``n_data`` of ``devices`` (default: every CUDA device; all
    of them when ``n_data`` is None)."""
    if n_model != 1:
        raise NotImplementedError("tensor parallelism is not ported (n_model must be 1)")
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n_data = len(devices) if n_data is None else n_data
    if not 0 < n_data <= len(devices):
        raise ValueError(f"n_data={n_data}: the mesh has {len(devices)} devices to take from")
    return Mesh(devices[:n_data])
