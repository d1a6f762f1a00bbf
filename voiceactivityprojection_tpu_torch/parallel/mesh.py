"""Device meshes: the ``"data"`` axis of context parallelism in one
process, and the ``"data"`` x ``"model"`` layout of processes that data and
tensor parallelism train over.

Counterpart of ``voiceactivityprojection_tpu/parallel/mesh.py``
(``make_mesh`` :24-33, ``shard_batch`` :46-61).

* ``Mesh``, for ``parallel/context.py``: one controller drives every
  shard, in order, as ``jax.shard_map`` drives a mesh from one program;
  the mesh is the sequence of devices its shards run on. A device may
  repeat: ``make_mesh(n_data=4, devices=[torch.device("cuda")] * 4)`` runs
  four shards on one card, and ``[torch.device("cpu")] * 4`` on the CPU (a
  JAX mesh takes distinct devices; its tests force several host devices
  instead).
* ``ProcessLayout``, for training: one process per shard, joined by
  ``init_distributed`` (NCCL on the card, gloo on the CPU). Rank ``d *
  n_model + m`` holds data shard ``d`` and model shard ``m``, JAX's
  ``reshape(n_data, n_model)``, and each axis has its own process group.
  The data axis splits a global batch into equal row blocks
  (``shard_batch``) and averages the gradients (``all_reduce_gradients``:
  one flattened, bucketed ``all_reduce``, JAX's ``psum`` over ``"data"``);
  the model axis carries the Megatron shards of ``parallel/tp.py``.
  ``make_mesh(n_model > 1)`` returns one once a process group exists.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from voiceactivityprojection_tpu_torch.ops.dropout import DropoutShard
from voiceactivityprojection_tpu_torch.utils.device import resolve_device

Device = Union[str, torch.device]
TIMEOUT_S = 600.0  # a collective that waits longer fails instead of hanging
BUCKET_BYTES = 25 << 20  # gradients all-reduced together, at most
# the rendezvous of workers a launcher started with a file store (env:// else)
INIT_METHOD_ENV = "VAP_DIST_INIT_METHOD"


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
) -> Union[Mesh, "ProcessLayout"]:
    """The first ``n_data`` of ``devices`` (default: every CUDA device; all
    of them when ``n_data`` is None). With ``n_model`` > 1, the
    ``ProcessLayout`` of the process group (``init_distributed`` first),
    whose world must be ``n_data * n_model``."""
    if n_model != 1:
        if not dist.is_initialized():
            raise RuntimeError("a mesh with a 'model' axis spans processes: call init_distributed() first")
        layout = ProcessLayout(n_model)
        if n_data is not None and n_data != layout.n_data:
            raise ValueError(f"n_data={n_data} x n_model={n_model} != world size {layout.world}")
        return layout
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n_data = len(devices) if n_data is None else n_data
    if not 0 < n_data <= len(devices):
        raise ValueError(f"n_data={n_data}: the mesh has {len(devices)} devices to take from")
    return Mesh(devices[:n_data])


# ------------------------------------------------------------------ processes --
def init_distributed(
    device: Device = "cuda",
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout_s: float = TIMEOUT_S,
) -> torch.device:
    """Joins this process to the group and returns its device. Rank, world
    size and the rendezvous come from the arguments, else from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT`` through ``env://``, or a ``file://`` store named by
    ``VAP_DIST_INIT_METHOD``, as the train CLI's own launcher and the tests
    use).
    The backend is NCCL on the card and gloo on the CPU unless named (gloo
    also reduces CUDA tensors, through the host, where two ranks share one
    card, which NCCL refuses). On the card the process takes
    ``cuda:LOCAL_RANK`` (modulo the cards there are); ``device="cuda"``
    without a card raises, never falls back to the CPU."""
    dev = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init_method = init_method or os.environ.get(INIT_METHOD_ENV, "env://")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def torchrun_env() -> bool:
    """Whether ``torchrun`` (or a launcher like it) set this process's rank
    and rendezvous."""
    rendezvous = INIT_METHOD_ENV in os.environ or all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT"))
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ and rendezvous


def spawn_local(cmd: List[str], n: int, timeout_s: Optional[float] = None) -> int:
    """Runs ``cmd`` in ``n`` local processes with the environment
    ``torchrun`` would give them (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``),
    the rendezvous a file store in a temporary directory, and returns the
    exit code of the first rank seen failing, or 0. One failing, or
    ``timeout_s`` passing, kills the others (then 124)."""
    t_end = None if timeout_s is None else time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="vap_ranks_") as tmp:
        procs = []
        try:
            for rank in range(n):
                env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                           LOCAL_WORLD_SIZE=str(n), **{INIT_METHOD_ENV: f"file://{tmp}/store"})
                procs.append(subprocess.Popen(cmd, env=env))
            while True:
                codes = [p.poll() for p in procs]  # every rank, each pass: a crash anywhere shows
                failed = next((c for c in codes if c not in (None, 0)), 0)
                if failed or None not in codes:
                    break
                if t_end is not None and time.monotonic() > t_end:
                    return 124
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    return failed


class ProcessLayout:
    """The processes of the group as a ``"data"`` x ``"model"`` grid. Every
    rank must build it, in the same order as its peers (it creates the
    groups of each axis)."""

    def __init__(self, n_model: int = 1):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        if n_model < 1 or self.world % n_model:
            raise ValueError(f"n_model={n_model} does not divide the world of {self.world} processes")
        self.n_model = n_model
        self.n_data = self.world // n_model
        self.data_rank, self.model_rank = divmod(self.rank, n_model)
        self.data_group: Optional[dist.ProcessGroup] = None  # None: the whole world
        self.model_group: Optional[dist.ProcessGroup] = None
        if n_model > 1:
            for m in range(n_model):
                g = dist.new_group([d * n_model + m for d in range(self.n_data)])
                if m == self.model_rank:
                    self.data_group = g
            for d in range(self.n_data):
                g = dist.new_group([d * n_model + m for m in range(n_model)])
                if d == self.data_rank:
                    self.model_group = g

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch; raises where the data axis
        does not divide it (as a JAX mesh refuses to shard it)."""
        if global_batch % self.n_data:
            raise ValueError(f"a global batch of {global_batch} does not split over {self.n_data} data ranks")
        b = global_batch // self.n_data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def dropout_shard(self, local_batch: int) -> DropoutShard:
        return DropoutShard(self.data_rank * local_batch, self.data_rank)

    def all_reduce_gradients(self, params: Iterable[torch.Tensor]) -> None:
        """Every gradient replaced by its mean over the data ranks: flattened
        into buckets of one dtype and device of at most ``BUCKET_BYTES``, one
        ``all_reduce`` each (a data axis of one rank reduces too: the same
        collectives run)."""
        by_kind: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
        for p in params:
            if p.grad is not None:
                by_kind.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
        for grads in by_kind.values():
            bucket, nbytes = [], 0
            for g in grads + [None]:  # None closes the last bucket
                if g is None or (bucket and nbytes + g.nbytes > BUCKET_BYTES):
                    self._all_reduce_mean(bucket)
                    bucket, nbytes = [], 0
                if g is not None:
                    bucket.append(g)
                    nbytes += g.nbytes

    def _all_reduce_mean(self, grads: List[torch.Tensor]) -> None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_group)
        flat.div_(self.n_data)
        offset = 0
        for g in grads:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each scalar metric as its mean over the data ranks: the global
        batch's, the same on every rank."""
        keys = list(metrics)
        flat = torch.stack([metrics[k].detach().float() for k in keys])
        dist.all_reduce(flat, group=self.data_group)
        flat.div_(self.n_data)
        return {k: flat[i] for i, k in enumerate(keys)}

    def broadcast(self, values: Sequence[float], src: int = 0) -> List[float]:
        """Rank ``src``'s floats on every rank."""
        obj = [list(values)]
        dist.broadcast_object_list(obj, src=src)
        return obj[0]


def shard_batch(batch: Dict[str, object], layout: Optional[ProcessLayout]) -> Dict[str, object]:
    """This rank's rows of every array of a global batch (JAX ``shard_batch``
    :46-61 places the global batch over the mesh); the batch itself without
    a layout."""
    if layout is None:
        return batch
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"the batch's arrays disagree on their row count: {sizes}")
    rows = layout.rows(sizes.pop())
    return {k: v[rows] for k, v in batch.items()}
