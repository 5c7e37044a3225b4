"""The (data, pair) rank grid (counterpart of tgt_tpu/parallel/mesh.py).

tgt_tpu runs one program over a named (data, pair) mesh of devices, row
major (``devices.reshape(num_data, num_pair)``): each process puts its rows
into one global batch array, GSPMD inserts the gradient all-reduce because
the loss is a mean over that global batch, and with ``num_pair_devices =
P > 1`` the node-pair tensors also shard their first node axis over
``pair``. The port runs ``D x P`` processes with one device each, and rank
``r`` sits at data index ``r // P`` and pair index ``r % P``, the same
row-major grid.

- The data axis: each data index holds its own rows, and the Trainer makes
  the step equal one process's step on the global batch (the masked means
  divide by counts summed over the ranks; one sum all-reduce per step adds
  up the ranks' gradients; ``tgt_torch/training/harness.py``).
- The pair axis: the ``P`` ranks of a data index load the same samples;
  each holds the i-rows ``[p N/P, (p+1) N/P)`` of the edge channel and the
  whole node channel. ``pair_groups`` makes one process group per pair
  group and returns this rank's ``PairAxis``; ``tgt_torch/parallel/ring.py``
  holds its collectives and the triplet ring, ``pair_layer.py`` the layer.
  As ``spec_for_array`` decides, a batch shards only when ``N % P == 0``;
  any other bucket runs on whole rows, unsharded, on every rank of the
  pair group, and only pair index 0 counts it (the Trainer), which gives
  the unsharded result, as tgt_tpu's replicated placement does.

GSPMD's placement functions (``make_mesh``, ``batch_sharding``,
``shard_batch``, ``make_global_batch``, ``replicated``) have no counterpart:
each rank simply holds its own rows.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
PAIR_AXIS = "pair"

# Batch keys that hold (b, N, N, ...) node-pair tensors, the only ones that
# shard over 'pair' (tgt_tpu/parallel/mesh.py:46-49): by name, never by a
# square shape. finetune/gap_pred's 'dist_bins' is (b, S, N, N), its dim 1
# the MC sample axis, so it is not one of them.
PAIR_TENSOR_KEYS = frozenset({
    "distance_matrix", "feature_matrix", "dist_input", "edge_mask",
})


class PairAxis:
    """This rank's place on the pair axis: ``size`` ranks (``P``) that hold
    the i-row blocks of one data index's edge channel, ``index`` its own,
    ``ranks`` their global ranks in pair order and ``group`` their process
    group (None: a local axis, whose collectives move nothing; only a size
    of 1 has one). ``stats`` counts what the pair collectives of
    ``ring.py`` move out of this rank: calls and bytes."""

    def __init__(self, size: int = 1, index: int = 0,
                 ranks: Optional[List[int]] = None, group=None):
        if group is None and size != 1:
            raise ValueError(f"a pair axis of size {size} needs its process "
                             "group")
        self.size = size
        self.index = index
        self.ranks = list(ranks) if ranks is not None else [index]
        self.group = group
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {"calls": 0, "bytes": 0}

    def shards(self, n: int) -> bool:
        """Whether a bucket of ``n`` nodes shards over this axis: tgt_tpu's
        ``spec_for_array`` (mesh.py:99-101) shards a pair tensor only when
        ``P`` divides ``N``, and replicates it otherwise."""
        return n % self.size == 0

    def rows(self, n: int) -> slice:
        """This rank's i-rows of an ``n``-node bucket."""
        blk = n // self.size
        return slice(self.index * blk, (self.index + 1) * blk)


def pair_groups(world_size: int, num_pair: int
                ) -> Tuple[int, int, PairAxis]:
    """(data index, pair index, this rank's ``PairAxis``) on the row-major
    ``(world_size / num_pair, num_pair)`` grid (tgt_tpu's ``make_mesh``).
    Every rank makes every pair group, in the same order, as
    ``dist.new_group`` requires. A world size that ``num_pair`` does not
    divide raises; one process without a group gets a local axis."""
    if num_pair < 1 or world_size % num_pair:
        raise ValueError(f"num_pair_devices={num_pair} does not divide the "
                         f"world size {world_size} (mesh "
                         f"{world_size // max(num_pair, 1)}x{num_pair} != "
                         f"{world_size} devices)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world_size > 1 and (not dist.is_initialized()
                           or dist.get_world_size() != world_size):
        raise ValueError(f"a world size of {world_size} needs its process "
                         "group (initialize_distributed)")
    data_index, pair_index = divmod(rank, num_pair)
    if not dist.is_initialized():
        return 0, 0, PairAxis()         # one process: a local axis
    mine = None
    for d in range(world_size // num_pair):
        ranks = list(range(d * num_pair, (d + 1) * num_pair))
        group = dist.new_group(ranks)
        if d == data_index:
            mine = PairAxis(num_pair, pair_index, ranks, group)
    return data_index, pair_index, mine


_CURRENT: List[Optional[PairAxis]] = [None]


@contextlib.contextmanager
def pair_scope(axis: Optional[PairAxis]) -> Iterator[Optional[PairAxis]]:
    """Run the models and schemes inside on ``axis`` (tgt_tpu: inside
    ``shard_map`` over 'pair'); None runs them on whole rows."""
    saved = _CURRENT[0]
    _CURRENT[0] = axis
    try:
        yield axis
    finally:
        _CURRENT[0] = saved


def current_pair_axis() -> Optional[PairAxis]:
    """The axis of the enclosing ``pair_scope``, or None."""
    return _CURRENT[0]


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


def gather_predictions(preds: Dict[str, np.ndarray], world_size: int,
                       contribute: bool = True) -> Dict[str, np.ndarray]:
    """Every rank's prediction shard joined in rank order, the same on
    every rank; the identity at a world size of 1. Shards of unequal
    length (``np.array_split`` of a split, e.g. 5 and 4) keep their own
    lengths, and a rank with no rows of the split adds none; 0-d values
    come back as one entry per contributing rank. A rank with
    ``contribute=False`` adds nothing: on the pair axis only pair index 0
    of each data index gives its samples, whose other pair ranks hold the
    same ones."""
    if world_size <= 1:
        return preds
    shards = [None] * world_size
    dist.all_gather_object(shards, {k: np.asarray(v)
                                    for k, v in preds.items()}
                           if contribute else {})
    shards = [s for s in shards if s]
    return {k: (np.stack([s[k] for s in shards]) if shards[0][k].ndim == 0
                else np.concatenate([s[k] for s in shards], axis=0))
            for k in (shards[0] if shards else {})}
