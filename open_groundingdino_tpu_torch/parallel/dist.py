"""Multi-process data parallelism over torch.distributed (the port of the JAX
package's parallel/mesh.py and the jax.distributed set-up in its main.py;
reference util/misc.py:520-558 init_distributed_mode).

The JAX package runs one program over the global batch: the batch is sharded
on the mesh's data axis and XLA sums the gradients.  The port runs one
process a GPU, each on its own shard of the global batch
(data/loader.shard_iter), and keeps that invariant by hand: the criterion
normalises by the global counts (models/criterion.py), the train step sums
the gradients and losses over the ranks before the clip
(parallel/train_state.py), every rank draws the random masks of the global
batch and keeps its own rows (`rand_local_rows`), and the evaluator's records
are gathered before they are accumulated (engine.py).  So an N-rank step on N
per-rank batches gives the loss, gradients and update of one process on
their concatenation, and an N-rank eval the stats of the whole val split.

The processes come from torchrun (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) or SLURM (SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID, with
MASTER_ADDR and MASTER_PORT set by the job script).  Without them nothing is
initialised, and every helper below is a no-op or an identity.
"""
from __future__ import annotations

import datetime
import hashlib
import os
from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

# a rank that dies leaves the others in a collective: they fail after this
# long instead of waiting forever (a checkpoint write or an eval pass on one
# rank takes minutes at most)
TIMEOUT_S = 1800
# gradients are summed as flat buffers of at most this many bytes, one
# all_reduce each (the f32 Swin-T model's 688 MB in three)
BUCKET_BYTES = 256 << 20


@dataclass(frozen=True)
class DistInfo:
    rank: int
    world_size: int
    local_rank: int
    device: torch.device


def _env_ranks() -> Optional[Tuple[int, int, int]]:
    """(rank, world size, local rank) from torchrun's or SLURM's variables,
    or None."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0))
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", 0)))
    return None


def process_device(device_arg: str, local_rank: int) -> torch.device:
    """cuda:LOCAL_RANK for a device argument of "cuda"; an argument that
    names an index (cuda:0), or the CPU, as given."""
    device = torch.device(device_arg)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def init_distributed(device_arg: str = "cuda", backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S) -> DistInfo:
    """Join the process group the environment describes and return this
    process's rank, world size, local rank and device; without torchrun's
    or SLURM's variables, rank 0 of 1 on `device_arg` with no group.  The
    backend is NCCL for a CUDA device and gloo for the CPU unless `backend`
    names one (NCCL refuses two ranks on one device: gloo runs them).  A
    group this process already joined is used as it is (a program that runs
    main more than once keeps one group: see is_initialized)."""
    if is_initialized():
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", 0)))
        device = process_device(device_arg, local)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return DistInfo(tdist.get_rank(), tdist.get_world_size(), local, device)
    ranks = _env_ranks()
    if ranks is None:
        return DistInfo(0, 1, 0, torch.device(device_arg))
    rank_, world, local = ranks
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"rank {rank_} of {world}: {', '.join(missing)} not set")
    device = process_device(device_arg, local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tdist.init_process_group(
        backend=backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method="env://", rank=rank_, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return DistInfo(rank_, world, local, device)


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if not is_initialized():
        return
    if tdist.get_backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """Consecutive tensors of one dtype and device, at most BUCKET_BYTES a
    bucket (a larger tensor alone)."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + nbytes > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place: flattened into buckets (one
    all_reduce a bucket) and copied back.  Nothing without a process
    group."""
    if not is_initialized():
        return
    with torch.profiler.record_function("ogd_torch::all_reduce_sum"):
        for bucket in _buckets(tensors):
            if len(bucket) == 1 and bucket[0].is_contiguous():
                tdist.all_reduce(bucket[0])
                continue
            flat = torch.cat([t.reshape(-1) for t in bucket])
            tdist.all_reduce(flat)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def all_gather_object(obj: Any) -> List[Any]:
    """[every rank's obj] in rank order ([obj] without a process group)."""
    if not is_initialized():
        return [obj]
    out: List[Any] = [None] * tdist.get_world_size()
    tdist.all_gather_object(out, obj)
    return out


def digest(tensors: Iterable[torch.Tensor]) -> str:
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_replicas(tensors: Sequence[torch.Tensor], what: str) -> Optional[str]:
    """Raise unless every rank holds the same bytes in `tensors` (compared by
    digest); returns the digest, or None in one process, which has nothing
    to compare."""
    if world_size() == 1:
        return None
    mine = digest(tensors)
    every = all_gather_object(mine)
    if len(set(every)) != 1:
        raise RuntimeError(f"{what} differ across ranks: {every}")
    return mine


def rand_local_rows(shape: Sequence[int], generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    """torch.rand(shape) for this rank's rows of the global batch: every rank
    draws the uniforms of world_size x shape[0] rows from the same generator
    state and keeps its own shape[0], so N ranks draw the masks one process
    draws for their concatenated batch (the JAX package draws from one key
    over the global batch).  One process draws shape itself: rows 0 to
    shape[0] of one draw are the numbers a draw of shape gives."""
    rows = shape[0]
    u = torch.rand((world_size() * rows, *shape[1:]), generator=generator, device=device)
    return u[rank() * rows:(rank() + 1) * rows]


def cleanup() -> None:
    """Leave the process group (nothing without one)."""
    if is_initialized():
        tdist.destroy_process_group()
