"""The yardstick of the Pairformer's training cell.

Model operations of AlphaFold 3's Pairformer trunk with its distogram
head, counted from the configuration and a crop's token count: the
multiply-adds (2 operations each) of every matrix product of one forward
of one crop of ``n`` tokens, unpadded. Padding, recomputation and
elementwise work earn nothing. A training step counts three forwards of
what the loss reads, and one of the single track after the embedding
(single attention and single transition), which feeds nothing the
distogram reads and so has no backward.

The rooflines of the triangle attention on the dense triplet core: the
bound time of the core's calls in the profiled span, ungated, at b = 1, n =
the crop's tokens, the configuration's head width and heads
(``bounds.dense_fwd`` and ``dense_bwd``), counted by the key-tiled route's
counters (``tiled_launches``), over the device time of every operation
launched inside the core's marked entry point (``TripletDenseCore.forward``
or ``.backward``: the head-major copies, the bias copy, the kernels and, in
the backward, its scratch).

The host time of the program's four Pairformer spans.

The single track's gap (``single_gap``, one of the numbers that decide
``correct``): the relative Frobenius distance between the program's and the
reference's single representation after the last block.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from h100bench.yardstick import bounds


def pair_forward_flops(cfg: dict, n: int) -> float:
    """The embedding, every block's pair updates and the head."""
    cs, cz, ct = cfg["single_width"], cfg["pair_width"], cfg["tri_mul_width"]
    inner = cfg["tri_att_heads"] * cfg["tri_att_head_width"]
    mult = cfg["transition_multiplier"]
    n2, n3 = n * n, n ** 3
    tri_mul = (2 * n2 * cz * 4 * ct + 2 * n2 * cz * cz     # a, b, gate
               + 2 * n3 * ct + 2 * n2 * ct * cz)            # sum over k, out
    tri_att = (2 * n2 * cz * (3 * inner + cfg["tri_att_heads"] + inner)
               + 4 * n3 * inner + 2 * n2 * inner * cz)      # q.k, a.v, out
    transition = 2 * n2 * cz * 2 * mult * cz + 2 * n2 * mult * cz * cz
    block = 2 * tri_mul + 2 * tri_att + transition
    embed = (2 * n * cfg["num_residue_types"] * cs + 2 * 2 * n * cs * cz
             + 2 * n2 * (2 * cfg["max_relative_offset"] + 2) * cz)
    head = 2 * n2 * cz * cfg["num_dist_bins"]
    return float(embed + cfg["num_blocks"] * block + head)


def single_forward_flops(cfg: dict, n: int) -> float:
    """Every block's single attention with pair bias and single
    transition."""
    cs, cz = cfg["single_width"], cfg["pair_width"]
    hs = cfg["single_heads"]
    inner = hs * cfg["single_head_width"]
    mult = cfg["transition_multiplier"]
    attention = (2 * n * cs * 4 * inner + 2 * n * n * cz * hs   # q k v g, bias
                 + 4 * n * n * inner + 2 * n * inner * cs)      # q.k, a.v, out
    transition = 2 * n * cs * 2 * mult * cs + 2 * n * mult * cs * cs
    return float(cfg["num_blocks"] * (attention + transition))


def train_flops(cfg: dict, sizes) -> float:
    """Forward and backward of crops of these token counts."""
    return sum(3.0 * pair_forward_flops(cfg, int(n))
               + single_forward_flops(cfg, int(n)) for n in sizes)

MODULE = "tgt_torch.ops.kernels.triplet_dense:"
CORES = {"dense_fwd": ("triplet_dense_fwd.tiled_launches",
                       "TripletDenseCore.forward", bounds.dense_fwd),
         "dense_bwd": ("triplet_dense_bwd.tiled_launches",
                       "TripletDenseCore.backward", bounds.dense_bwd)}


def roofline(rec, core: str) -> Optional[float]:
    t, cfg = rec.get("trace"), rec["cfg"]
    if rec["mix"]["driver"] != "train_pairformer" or not t:
        return None
    counter, call, count = CORES[core]
    d, h = cfg["tri_att_head_width"], cfg["tri_att_heads"]
    itemsize = 2 if cfg.get("mixed_precision") else 4
    bound = sum(i["counters"].get(counter, 0) * bounds.seconds(
        *count(1, i["tokens"], d, h, itemsize, gated=False), itemsize)
        for i in t["items"])
    device = t.get("calls", {}).get(call, 0.0)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device


SPANS = ("pairformer.tri_mul", "pairformer.tri_att", "pairformer.transition",
         "pairformer.single")


def host_ms(rows: List[Dict]) -> Optional[float]:
    """The host ms of the program's four Pairformer spans, summed, from
    the rows its span recorder keeps (``t0``, ``t1`` in ns)."""
    own = [r for r in rows if r["name"] in SPANS]
    if not own:
        return None
    return sum((r["t1"] - r["t0"]) / 1e6 for r in own)


def single_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """||prog - ref|| / ||ref|| over every entry, in float64; infinite where
    the program's holds a non-finite entry."""
    prog, ref = prog.double(), ref.double()
    if not bool(torch.isfinite(prog).all()):
        return float("inf")
    return float((prog - ref).norm() / ref.norm())
