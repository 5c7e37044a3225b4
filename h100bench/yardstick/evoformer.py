"""The yardstick of the Evoformer's training cell.

Model operations of AlphaFold 2's Evoformer with its extra-MSA stack, its
input embedder and its two heads, counted from the configuration and a
crop's residues r, cluster rows s and extra rows S: the multiply-adds (2
operations each) of every matrix product of one forward of one crop,
unpadded. Padding, recomputation and elementwise work earn nothing. Global
column attention's query is counted as the port computes it, the mean
taken before the projection. A training step counts three forwards.

The outer product mean's roofline: the bound time of the
``OuterProductMean`` calls in the profiled span, the larger of the
operations of the sum over s and of the output projection at the peak and
their bytes at the memory rate (a and b read, the (r c)^2 outer products
written and read back, the weight read, the projection written;
``opm_bound``, ``bounds.seconds``), over the device time of every operation
launched inside a marked ``OuterProductMean.forward`` (the two matrix
products, the relayout between them and the division). The calls are
counted by the program's ``outer_product_mean`` counter, forward and remat
replay alike, in the proportion of the extra-MSA and main blocks.

The host time of the program's four MSA-track spans.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from h100bench.yardstick import bounds

DRIVER = "train_evoformer"
MSA_SPANS = ("evoformer.msa_row", "evoformer.msa_col",
             "evoformer.msa_transition", "evoformer.opm")
TARGET_FEAT, MSA_FEAT, EXTRA_MSA_FEAT, MSA_CLASSES = 22, 49, 25, 23


def _dims(cfg: dict, extra: bool):
    if extra:
        return (cfg["extra_msa_width"], cfg["extra_msa_heads"],
                cfg["extra_msa_head_width"])
    return cfg["msa_width"], cfg["msa_heads"], cfg["msa_head_width"]


def msa_track_flops(cfg: dict, r: int, s: int, extra: bool) -> float:
    """One block's row attention, column (or global column) attention,
    MSA transition and outer product mean."""
    cm, h, c = _dims(cfg, extra)
    cz, co = cfg["pair_width"], cfg["opm_width"]
    inner, tokens = h * c, s * r
    proj = 2 * tokens * cm * inner * 2          # the gate and the output
    row = (proj + 2 * tokens * cm * 3 * inner + 2 * r * r * cz * h
           + 4 * s * h * r * r * c)
    if extra:
        col = (proj + 2 * r * cm * inner + 2 * tokens * cm * 2 * c
               + 4 * r * h * s * c)
    else:
        col = proj + 2 * tokens * cm * 3 * inner + 4 * r * h * s * s * c
    transition = 2 * 2 * tokens * cm * cfg["transition_multiplier"] * cm
    opm = (2 * tokens * cm * 2 * co + 2 * s * (r * co) ** 2
           + 2 * r * r * co * co * cz)
    return float(row + col + transition + opm)


def pair_track_flops(cfg: dict, r: int) -> float:
    """One block's triangle multiplications, triangle attentions and pair
    transition."""
    cz, ct = cfg["pair_width"], cfg["tri_mul_width"]
    ha = cfg["tri_att_heads"]
    inner = ha * cfg["tri_att_head_width"]
    r2, r3 = r * r, r ** 3
    tri_mul = (2 * r2 * cz * 4 * ct + 2 * r2 * cz * cz + 2 * r3 * ct
               + 2 * r2 * ct * cz)
    tri_att = (2 * r2 * cz * (3 * inner + ha + inner) + 4 * r3 * inner
               + 2 * r2 * inner * cz)
    transition = 2 * 2 * r2 * cz * cfg["transition_multiplier"] * cz
    return float(2 * tri_mul + 2 * tri_att + transition)


def forward_flops(cfg: dict, r: int, s: int, extra_s: int) -> float:
    cm, cz, ce = cfg["msa_width"], cfg["pair_width"], cfg["extra_msa_width"]
    embed = (2 * 2 * r * TARGET_FEAT * cz
             + 2 * r * r * (2 * cfg["max_relative_offset"] + 1) * cz
             + 2 * s * r * MSA_FEAT * cm + 2 * r * TARGET_FEAT * cm
             + 2 * extra_s * r * EXTRA_MSA_FEAT * ce)
    heads = (2 * r * r * cz * cfg["num_dist_bins"]
             + 2 * s * r * cm * MSA_CLASSES)
    pair = pair_track_flops(cfg, r)
    blocks = (cfg["num_extra_blocks"] * (msa_track_flops(cfg, r, extra_s,
                                                         True) + pair)
              + cfg["num_blocks"] * (msa_track_flops(cfg, r, s, False)
                                     + pair))
    return float(embed + blocks + heads)


def train_flops(cfg: dict, crops) -> float:
    """Forward and backward of crops given as (r, s, S)."""
    return sum(3.0 * forward_flops(cfg, *crop) for crop in crops)


def opm_bound(cfg: dict, r: int, s: int, itemsize: int):
    """(bytes, operations) of one ``OuterProductMean`` call: the sum over
    s and the output projection."""
    co, cz = cfg["opm_width"], cfg["pair_width"]
    outer = r * r * co * co
    flops = 2.0 * s * (r * co) ** 2 + 2.0 * outer * cz
    nbytes = (2 * s * r * co + 2 * outer + cz * co * co
              + r * r * cz) * itemsize
    return nbytes, flops


def opm_roofline(rec) -> Optional[float]:
    t, cfg = rec.get("trace"), rec["cfg"]
    if rec["mix"]["driver"] != DRIVER or not t:
        return None
    itemsize = 2 if cfg.get("mixed_precision") else 4
    extra, main = cfg["num_extra_blocks"], cfg["num_blocks"]
    bound = 0.0
    for item in t["items"]:
        calls = item["counters"].get("msa.outer_product_mean", 0)
        per_pass = 0.0
        for blocks, s in ((extra, item["extra"]), (main, item["sequences"])):
            per_pass += blocks * bounds.seconds(
                *opm_bound(cfg, item["tokens"], s, itemsize), itemsize)
        bound += calls / (extra + main) * per_pass
    device = t.get("calls", {}).get("OuterProductMean.forward", 0.0)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device


def msa_host_ms(rows: List[Dict]) -> Optional[float]:
    """The host ms of the program's four MSA-track spans, summed, from the
    rows its span recorder keeps (``t0``, ``t1`` in ns)."""
    own = [r for r in rows if r["name"] in MSA_SPANS]
    if not own:
        return None
    return sum((r["t1"] - r["t0"]) / 1e6 for r in own)
