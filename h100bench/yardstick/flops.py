"""Model operations of the TGT distance predictor, counted from the
configuration and a molecule's own atom count: the multiply-adds (2
operations each) of every matrix product of one forward of one molecule of
``n`` atoms, unpadded. Padding, recomputation and elementwise work earn
nothing; a training step counts three forwards (forward and backward)."""
from __future__ import annotations


def forward_flops(cfg: dict, n: int) -> float:
    wh, we = cfg["node_width"], cfg["edge_width"]
    heads, th = cfg["num_heads"], cfg["triplet_heads"]
    kk, bins = cfg.get("num_3d_kernels", 128), cfg["num_dist_bins"]
    ln = round(wh * cfg["node_ffn_multiplier"])
    le = round(we * cfg["edge_ffn_multiplier"])
    n2, n3 = n * n, n ** 3
    total = 2 * n2 * kk * kk + 2 * n2 * kk * we           # Gaussian 3D embed
    gated = cfg["triplet_type"] in ("attention", "aggregate")
    if cfg["triplet_type"].startswith("attention"):
        triplet = (2 * (2 * n2 * we * 3 * we)                 # QKV in, out
                   + 2 * (2 * n2 * we * (2 if gated else 1) * th)
                   + 2 * 4 * n3 * we                          # q.k and a.v
                   + 2 * n2 * 2 * we * we)                    # lin_O
    elif cfg["triplet_type"].startswith("aggregate"):
        triplet = (2 * n2 * we * 2 * we                       # V in, out
                   + 2 * n2 * we * (4 if gated else 2) * th
                   + 2 * 2 * n3 * we                          # a.v
                   + 2 * n2 * 2 * we * we)
    else:
        raise ValueError(f"no count for triplet type {cfg['triplet_type']!r}")
    if not th:
        triplet = 0
    edge_ffn = 2 * (2 * n2 * we * le)
    node_layer = (2 * n * wh * 3 * wh + 2 * n2 * we * 2 * heads
                  + 2 * (2 * n2 * wh) + 2 * n * wh * wh + 2 * n2 * heads * we
                  + 2 * (2 * n * wh * ln))
    edge_layer = (2 * n * wh * 2 * wh + 2 * n2 * we * heads + 2 * n2 * wh
                  + 2 * n2 * heads * we)
    reps = cfg.get("layer_multiplier", 1)
    height = cfg["model_height"]
    total += reps * ((height - 1) * node_layer + edge_layer
                     + height * (triplet + edge_ffn))
    return float(total + 2 * n2 * we * bins)               # distance head


def train_flops(cfg: dict, sizes) -> float:
    """Forward and backward of a batch of molecules of these sizes."""
    return 3.0 * sum(forward_flops(cfg, int(n)) for n in sizes)


def serve_flops(cfg: dict, sizes, draws: int) -> float:
    """``draws`` MC-dropout forwards of each molecule."""
    return float(draws) * sum(forward_flops(cfg, int(n)) for n in sizes)
