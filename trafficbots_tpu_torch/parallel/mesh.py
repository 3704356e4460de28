"""Data parallelism over torch.distributed: the process group, the gradient
and metric reductions, the union of host objects.

Counterpart of `trafficbots_tpu/parallel/mesh.py`. The JAX package shards
every global batch over a 1-D "data" mesh and reduces inside one
`shard_map` step; the port runs one process per rank (`torchrun`), each with
its slice of every global batch, the parameters and the optimizer state
replicated. The gradients are averaged by one flat all-reduce inside the
training step, before the clip (`all_reduce_mean_`, JAX's `pmean`), the
metric sums and counts summed (`all_reduce_sum`, `psum`), and the host-side
collections unioned in rank order (`allgather_pyobj`). There is no
`DistributedDataParallel`: its reducer would fight the rollout's per-step
recompute, the parameters that get no gradient, and the NaN guard, which
must see the reduced gradients.

Every function here is a no-op, and calls no collective, when no process
group is initialized or it has one rank: a single-process run is the same
program, bit for bit.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

# a rank that dies or hangs fails the others' next collective after this
# long instead of hanging them
TIMEOUT_S = 600.0
_MASK64 = (1 << 64) - 1


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _active() else 0


def world_size() -> int:
    return dist.get_world_size() if _active() else 1


def is_main() -> bool:
    """Rank 0 (or a single process): the one that
    writes the host artifacts and prints."""
    return rank() == 0


def choose_backend(device, local_world_size: int) -> str:
    """`nccl` when the ranks are on CUDA and no two local ranks share a
    card, `gloo` otherwise (the CPU, or ranks sharing one card)."""
    device = torch.device(device)
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_from_env(device="cuda") -> bool:
    """Join the process group the `torchrun` environment describes (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`,
    `MASTER_PORT`). Nothing happens when `WORLD_SIZE` is absent or 1, or a
    group already exists. On CUDA the rank's card becomes the current device
    first (`LOCAL_RANK` modulo the cards: ranks beyond the card count share
    them), since the kernels launch on the current device. -> True when this
    call created the group (its caller destroys it)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or _active():
        return False
    r = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", r))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"WORLD_SIZE={world} on CUDA, but CUDA is not available; pass device=cpu")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = choose_backend(device, local_world)
    # env:// reads MASTER_ADDR / MASTER_PORT, and under torchrun joins the
    # store its agent already serves
    dist.init_process_group(backend, init_method="env://", rank=r, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    where = f"cuda:{torch.cuda.current_device()}" if device.type == "cuda" else "cpu"
    print(f"data parallel: rank {r} of {world}, backend {backend}, device {where}, "
          f"{local_world} local ranks", flush=True)
    return True


def destroy() -> None:
    if _active():
        dist.destroy_process_group()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def allgather_pyobj(obj: Any) -> List[Any]:
    """Every rank's picklable `obj`, in rank order, on every rank (ragged
    collections: the WOMD inputs and submission payloads after each rank's
    pad rows were dropped). With one process: [obj], no collective."""
    n = world_size()
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj)
    return out


def all_reduce_mean_(params: Iterable[torch.Tensor]) -> None:
    """Average the parameters' gradients over the ranks in place, in one
    collective: every gradient flattened into one buffer (a None gradient
    as zeros), summed, divided by the world size and copied back into each
    `.grad` (a tensor of its own, not a view of the buffer: the reductions
    that read it then take the path they take on any other gradient)."""
    n = world_size()
    if n == 1:
        return
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in params])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= n
    offset = 0
    for p in params:
        mean = flat[offset:offset + p.numel()].view_as(p)
        if p.grad is None:
            p.grad = mean.clone()
        else:
            p.grad.copy_(mean)
        offset += p.numel()


def all_reduce_sum(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar tensors summed over the ranks, in one collective."""
    if world_size() == 1 or not metrics:
        return metrics
    names = list(metrics)
    flat = torch.stack([metrics[k].float().reshape(()) for k in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return {k: flat[i] for i, k in enumerate(names)}


def rank_seed(seed: int, rank_: Optional[int] = None, world: Optional[int] = None) -> int:
    """The rank's seed of a training step: `seed` itself with one rank; with
    more, a fixed mix of (seed, rank) (splitmix64), so each rank's dropout,
    latent and teacher-forcing draws are independent (JAX folds the data
    axis index into the step's key). `rank_` and `world` default to this
    process's."""
    world = world_size() if world is None else world
    if world == 1:
        return seed
    r = rank() if rank_ is None else rank_
    z = (seed + (r + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 2  # 62 bits, as the run's own seed stream draws them
