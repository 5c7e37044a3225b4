"""Data parallelism across processes (counterpart of
tgt_tpu/parallel/mesh.py, its data axis).

tgt_tpu runs one program over a named (data, pair) mesh: each process puts
its rows into one global batch array, and GSPMD inserts the gradient
all-reduce because the loss is a mean over that global batch. The port
runs N processes with one device each, and each rank simply holds its own
rows. So GSPMD's placement functions (``make_mesh``, ``batch_sharding``,
``shard_batch``, ``spec_for_array``, ``make_global_batch``,
``replicated``) have no counterpart here. What they achieve, a step equal
to one process's step on the concatenated batch, is the Trainer's: the
masked means of the losses divide by counts summed over the ranks, and one
sum all-reduce per step adds up the ranks' gradients
(``tgt_torch/training/harness.py``).

The pair axis (``tgt_tpu/parallel/ring.py``, ``pair_layer.py``, the
Trainer's ``num_pair_devices``) is not ported yet (ROADMAP.md, module
item 5, the pair axis).
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
PAIR_AXIS = "pair"


def rank_device(device: Optional[Union[str, torch.device]] = None,
                rank: Optional[int] = None) -> torch.device:
    """The device of this process: ``device`` when the caller names one,
    else ``cuda:<LOCAL_RANK>`` (torchrun's variable), else ``cuda:<rank>``
    (``rank``, or that of the process group). A CUDA device whose index is
    not below ``torch.cuda.device_count()`` raises: a rank never shares
    another's card by wrapping around, and never falls back to the CPU."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = rank if rank is not None else (
                dist.get_rank() if dist.is_initialized() else 0)
        device = torch.device("cuda", int(local))
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        index = device.index if device.index is not None else (
            torch.cuda.current_device() if count else 0)
        if index >= count:
            raise ValueError(
                f"this rank's device cuda:{index} does not exist: "
                f"{count} CUDA device(s) are visible; run one process per "
                "card, or name the device")
        device = torch.device("cuda", index)
    return device


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None,
                           timeout: Optional[datetime.timedelta] = None
                           ) -> Tuple[int, int]:
    """The process group of a multi-process run. Returns (rank,
    world_size).

    The rendezvous comes from tgt_tpu's yaml keys (``jax_coordinator``
    host:port, ``jax_num_processes``, ``jax_process_id``), else from
    torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``. With neither, or a world size of 1, the run is one
    process: ``(0, 1)``, and no group is made. An existing group is used as
    it is. The backend defaults to NCCL for a CUDA device and gloo for the
    CPU; ``backend="gloo"`` also moves CUDA tensors (all-reduce and
    broadcast), which lets two ranks share one card. ``timeout`` bounds
    the rendezvous and every collective (torch's default without it)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if not num_processes or num_processes <= 1:
        return 0, 1
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator is None or process_id is None:
        raise ValueError(
            f"a world size of {num_processes} needs a rendezvous: set "
            "jax_coordinator, jax_num_processes and jax_process_id in the "
            "config, or run under torchrun (RANK, WORLD_SIZE, MASTER_ADDR, "
            "MASTER_PORT)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    device = rank_device(device, process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        **({} if timeout is None else {"timeout": timeout}))
    return process_id, num_processes


def gather_predictions(preds: Dict[str, np.ndarray],
                       world_size: int) -> Dict[str, np.ndarray]:
    """Every rank's prediction shard joined in rank order, the same on
    every rank; the identity at a world size of 1. Shards of unequal
    length (``np.array_split`` of a split, e.g. 5 and 4) keep their own
    lengths, and a rank with no rows of the split adds none; 0-d values
    come back as ``(world_size,)``."""
    if world_size <= 1:
        return preds
    shards = [None] * world_size
    dist.all_gather_object(shards, {k: np.asarray(v)
                                    for k, v in preds.items()})
    shards = [s for s in shards if s]
    return {k: (np.stack([s[k] for s in shards]) if shards[0][k].ndim == 0
                else np.concatenate([s[k] for s in shards], axis=0))
            for k in (shards[0] if shards else {})}
