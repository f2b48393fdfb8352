"""The port's data-parallel layer, the counterpart of
mmtrack_tpu/parallel/mesh.py.

JAX places a tree on a device mesh and XLA emits the collectives. The
PyTorch idiom is one process per card, started by torchrun (`python -m
torch.distributed.run --nproc_per_node N ...`), with explicit collectives
over torch.distributed:

  - `init_distributed(device)` joins the process group from torchrun's
    RANK / WORLD_SIZE / LOCAL_RANK and returns this rank's `Shard`. The
    backend is the transport: NCCL when every rank on the host has a card
    of its own, gloo when ranks share a card or run on the CPU (a shared
    card's tensors then pass through the host). It prints its choice.
  - A `Shard` is this rank's share of a global batch (`rows`, `local`) and
    the reductions a data-parallel step needs (`total`, `sum`, `average_`,
    `mean_stats`, `gather`). `SINGLE` is the one-process shard: every
    reduction is the identity, so a step written for a shard runs
    unchanged in one process.
  - `process_local_slice(n)` is which slice of a global work list this
    process owns (the JAX function's arithmetic over rank and world);
    `replicate` broadcasts a module's parameters and buffers from rank 0;
    `shard_batch` keeps this rank's rows of every leaf.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class RowDraws:
    """A generator for per-sample draws of a sharded step: a draw for this
    rank's rows is the draw for the global `batch`, of which `rows` are
    kept, so every rank sees the samples the one-process step draws for
    its rows (models/layers.py::drop_path)."""
    generator: torch.Generator
    batch: int
    rows: slice


class _SumOverRanks(torch.autograd.Function):
    """Sum of a tensor over the ranks, differentiable: every rank's loss
    reads the sum, so each rank's gradient of its term is the sum of the
    ranks' gradients of the sum."""

    @staticmethod
    def forward(ctx, t, shard):
        ctx.shard = shard
        return shard._reduce(t.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard._reduce(grad.contiguous().clone()), None


@dataclass(frozen=True)
class Shard:
    """This rank's share of a data-parallel step over `world` ranks."""
    rank: int = 0
    world: int = 1
    backend: str = "none"
    group: object = None

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of `n`, which must divide
        over the ranks."""
        if n % self.world:
            raise ValueError(f"a global batch of {n} does not divide over {self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def local(self, x):
        """This rank's rows of `x` (numpy array or tensor)."""
        return x[self.rows(x.shape[0])]

    def local_batch(self, batch: dict, keys=None) -> dict:
        return {k: self.local(batch[k]) for k in (keys or batch)}

    def rolled(self, x, shift: int = 1):
        """This rank's rows of the global `x` rolled by `shift` along the
        batch (STARK's and MixFormer's negatives), without rolling it."""
        r = self.rows(x.shape[0])
        idx = (np.arange(r.start, r.stop) - shift) % x.shape[0]
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(idx, device=x.device)]
        return x[idx]

    def draws(self, generator: torch.Generator, batch: int):
        """`generator` for the per-sample draws of this rank's rows."""
        return generator if self.world == 1 else RowDraws(generator, batch, self.rows(batch))

    def _in_place(self, t: torch.Tensor, collective) -> torch.Tensor:
        """collective(t) in place; a card's tensor passes through the host
        under gloo."""
        if t.is_cuda and self.backend == "gloo":
            host = t.cpu()
            collective(host)
            t.copy_(host)
        else:
            collective(t)
        return t

    def _reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum of `flat` over the ranks, in place."""
        return self._in_place(flat, lambda t: dist.all_reduce(t, group=self.group))

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of a count over the ranks (no gradient): a loss normaliser
        of the global batch."""
        if self.world == 1:
            return t
        return self._reduce(t.detach().clone())

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the ranks, with its gradient: a quantity that
        the global program reduces over the whole batch inside the model
        (LWL's learner, ops/optimization.py::steepest_descent_gn)."""
        return t if self.world == 1 else _SumOverRanks.apply(t, self)

    def average_(self, tensors: list) -> None:
        """Average `tensors` (the gradients) over the ranks in place, as one
        flat buffer: one collective a step."""
        if self.world == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._reduce(flat).div_(self.world)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def mean_stats(self, stats: dict) -> dict:
        """Step statistics averaged over the ranks: each rank's value is its
        share of the global batch's (a mean over equal rows, or a sum over
        its rows divided by the global count times the world)."""
        if self.world == 1 or not stats:
            return stats
        keys = list(stats)
        flat = torch.stack([stats[k].detach().float().reshape(()) for k in keys])
        self._reduce(flat).div_(self.world)
        return dict(zip(keys, flat.unbind()))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of equal per-rank batches `t`, on every rank,
        in rank order."""
        if self.world == 1:
            return t
        src = t.contiguous()
        dev = src.device
        if src.is_cuda and self.backend == "gloo":
            src = src.cpu()
        out = torch.empty((self.world * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        if src.is_cuda:
            dist.all_gather_into_tensor(out, src, group=self.group)
        else:
            dist.all_gather(list(out.chunk(self.world)), src, group=self.group)
        return out.to(dev)

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.group)


SINGLE = Shard()


def backend_for(device: torch.device, local_world: int) -> str:
    """NCCL when every one of the host's `local_world` ranks has a card of
    its own, gloo when ranks share a card or run on the CPU."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device, init_method: str = "env://") -> tuple[Shard, torch.device]:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE; MASTER_ADDR / MASTER_PORT for the
    default `env://`, or a `file://` store) on `device` ('cuda' or
    'cpu'), on `local_device(device)`. Returns (this rank's Shard, its
    device)."""
    rank, world = launched_rank()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = local_device(device)
    backend = backend_for(device, local_world)
    why = ("a card per rank" if backend == "nccl" else
           "ranks share a card" if device.type == "cuda" else "ranks on the CPU")
    print(f"rank {rank} of {world}: backend {backend} ({why}), device {device}", flush=True)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, **kw)
    return Shard(rank, world, backend, dist.group.WORLD), device


def launched_rank() -> tuple[int, int]:
    """(rank, world) of this process: the process group's when one is
    initialized, else torchrun's RANK / WORLD_SIZE, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))


def local_device(device) -> torch.device:
    """`device` for this process: a card's rank takes cuda:{LOCAL_RANK %
    device_count} (ranks share cards when there are more ranks than
    cards); 'cuda' without a card raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --device cpu to run on the CPU)")
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                          % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def process_local_slice(n_items: int) -> slice:
    """Which slice of a global work list this process owns: ceil(n /
    world) items from rank x that many (the JAX function's arithmetic;
    the last rank may own fewer, or none), over `launched_rank`; slice(0,
    n) in a process that torchrun did not start."""
    rank, world = launched_rank()
    per = -(-n_items // world)
    start = rank * per
    return slice(start, min(start + per, n_items))


def replicate(module: torch.nn.Module, shard: Shard) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from rank 0 in place."""
    if shard.world > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            shard._in_place(t.data, lambda x: dist.broadcast(x, 0, group=shard.group))
    return module


def shard_batch(batch: dict, shard: Shard) -> dict:
    """This rank's rows of every leaf of a global batch."""
    return shard.local_batch(batch)
