"""Data parallelism over a ``torch.distributed`` process group.

Counterpart of ``nisqa_tpu/parallel/mesh.py``. The JAX package shards each
batch over a 1-D device mesh and lets XLA insert the collectives; the port
runs one process per card (``torchrun`` starts them) in one process group,
with its collectives written out:

  * training: each (batch, sample-rate) group of ``tr_bs`` rows is padded
    to a multiple of the rank count by repeating its first row
    (:func:`shard_rows`); every rank runs its slice. Masked batch norm sums
    its statistics over the ranks (:func:`all_reduce_sum`, whose backward
    sums the gradient), each rank's loss divides by the global count of
    valid targets, and :func:`all_reduce_grads` sums the gradients, so
    every rank steps Adam on the gradient of the global loss and the
    weights stay equal on every rank;
  * serving: each rank runs whole batches of the plan (``plan[rank::W]``)
    and one SUM all-reduce of the rows each rank owns
    (:func:`sum_rows`) assembles the result on every rank.

Parameters and buffers start equal: :func:`broadcast_module` copies rank
0's. One process with ``tr_parallel`` is one device, as a 1-device mesh is
in JAX; a launcher with one process is a group of size 1 whose collectives
are identities.
"""

from __future__ import annotations

import datetime
import os
import sys
from dataclasses import dataclass

import torch
import torch.distributed as dist

# a finite timeout: when a rank dies, the others' collectives end with an
# error instead of waiting for ever
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class DataParallel:
    """One rank's view of the process group: its rank, the group's size,
    the group, its backend and the rank's device."""

    rank: int
    size: int
    group: object
    backend: str
    device: torch.device


def init_data_parallel(args: dict, device: torch.device) -> DataParallel | None:
    """The process group of a ``tr_parallel`` run under a launcher, or None.

    Under ``torchrun`` (``WORLD_SIZE`` in the environment) the rank takes
    ``cuda:LOCAL_RANK % device_count()`` (set as the current device before
    any stream, generator or engine is built) and joins the group. The
    ranks trade their cards' UUIDs through the launcher's store first: the
    backend is "nccl" when no two ranks hold the same card (also under a
    per-rank ``CUDA_VISIBLE_DEVICES``), "gloo" when some share one (NCCL
    refuses two ranks on one device; rank 0 says so) and on the CPU. A
    group that exists already is joined as it is. On CUDA, local rank 0
    builds the kernel library while the others wait. Without a launcher it
    returns None, and with more than one card visible prints that
    ``torchrun`` is how to use them. Several ranks without ``tr_parallel``,
    or a failed init, raise: it never runs one device in silence.
    """
    size = int(os.environ.get("WORLD_SIZE", 1))
    if not args.get("tr_parallel"):
        if size > 1:
            raise RuntimeError(f"{size} ranks were launched but tr_parallel is off: set "
                               "tr_parallel: true to run them as one group, or launch one")
        return None
    if "WORLD_SIZE" not in os.environ:
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            print(f"nisqa_tpu_torch: tr_parallel: one process runs on one of the "
                  f"{torch.cuda.device_count()} visible cards; launch with torchrun "
                  "--nproc_per_node N to use N of them", file=sys.stderr)
        return None
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        _init_group(device)
    if device.type == "cuda":
        from ..ops import _build

        if local == 0:
            _build.build()
        barrier(dist.group.WORLD)
    return DataParallel(dist.get_rank(), dist.get_world_size(), dist.group.WORLD,
                        dist.get_backend(), device)


def _init_group(device: torch.device):
    """The default group over the launcher's ``env://`` store, its backend
    chosen from the ranks' cards (:func:`card_backend`)."""
    store, rank, size = next(dist.rendezvous("env://", timeout=TIMEOUT))
    store.set_timeout(TIMEOUT)
    backend = "gloo"
    if device.type == "cuda":
        uuid = str(torch.cuda.get_device_properties(device).uuid)
        cards = exchange(dist.PrefixStore("nisqa_tpu_torch/cards", store), rank, size, uuid)
        backend = card_backend(cards)
        if backend == "gloo" and rank == 0:
            print(f"nisqa_tpu_torch: {size} ranks on {len(set(cards))} card(s): the group runs "
                  "over gloo, since NCCL refuses two ranks on one card", file=sys.stderr)
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg", store), rank=rank,
                            world_size=size, timeout=TIMEOUT)


def exchange(store, rank: int, size: int, value: str) -> list:
    """Every rank's ``value``, in rank order, through ``store``."""
    store.set(str(rank), value)
    return [store.get(str(r)).decode() for r in range(size)]


def card_backend(cards) -> str:
    """"nccl" when every rank holds a card of its own (``cards``: each
    rank's card UUID), else "gloo"."""
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


def destroy_data_parallel():
    """Ends the process group, if there is one (the CLIs call it on exit)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier(group):
    """Waits for every rank of ``group`` (NCCL on the rank's current card)."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over ranks of x; dL/dx = the sum over ranks of dL/dy,
    since every rank's loss reads y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x, group):
    """The sum of ``x`` over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_reduce_grads(params, group):
    """Sums every ``.grad`` of ``params`` over the ranks, in one flat SUM
    all-reduce. A sum, not DDP's mean: each rank's loss is its share of the
    global loss. Parameters without a gradient stay without one."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    pos = 0
    for g in grads:
        g.copy_(flat[pos : pos + g.numel()].view_as(g))
        pos += g.numel()


@torch.no_grad()
def broadcast_module(module, group):
    """Copies rank 0's parameters and buffers to every rank of ``group``
    (the default group, whose ranks are the global ones)."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=group)


def shard_rows(n_real: int, size: int, rank: int):
    """(B, lo, hi): a group of ``n_real`` rows padded to ``B``, the next
    multiple of ``size``; the rank takes rows ``[lo, hi)`` of it."""
    per = -(-n_real // size)
    return per * size, rank * per, (rank + 1) * per


def sum_rows(rows, values, n: int, group):
    """(n, K) on every rank: each rank's ``values`` (R, K) at its ``rows``
    (R,) of a zero tensor, summed over the ranks. A row one rank owns comes
    back exact; a row every rank writes (a step's loss share) is summed."""
    out = torch.zeros((n, values.shape[1]), dtype=values.dtype, device=values.device)
    out.index_copy_(0, rows, values)
    dist.all_reduce(out, group=group)
    return out
