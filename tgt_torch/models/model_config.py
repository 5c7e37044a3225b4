"""Static model hyperparameters of the TGT family (counterpart of
tgt_tpu/models/model_config.py, field for field, so a config parsed by
either package compares equal).

Per-layer config arrays (the reference's TGT_Encoder.IndivConfig): any field
in INDIV_FIELDS may be a tuple of length ``model_height``; layer i is built
from ``layer_cfg(i)``. Widths stay uniform (the residual streams must line
up, as in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

INDIV_FIELDS = ("num_heads", "triplet_heads", "triplet_type",
                "triplet_dropout", "activation", "scale_degree",
                "node_ffn_multiplier", "edge_ffn_multiplier",
                "source_dropout", "drop_path", "node_act_dropout",
                "edge_act_dropout")


@dataclasses.dataclass(frozen=True)
class TGTConfig:
    # widths / heads
    node_width: int = 768
    edge_width: int = 256
    num_heads: int = 64
    # stack
    model_height: int = 4
    layer_multiplier: int = 1
    node_ended: bool = True
    edge_ended: bool = True
    egt_simple: bool = False
    # triplet
    triplet_heads: int = 0
    triplet_type: str = "aggregate"
    triplet_dropout: float = 0.0
    # regularization / activation
    activation: str = "gelu"
    scale_degree: bool = True
    node_ffn_multiplier: float = 1.0
    edge_ffn_multiplier: float = 1.0
    source_dropout: float = 0.0
    drop_path: float = 0.0
    node_act_dropout: float = 0.0
    edge_act_dropout: float = 0.0
    # input embedding
    upto_hop: int = 32
    embed_3d_type: str = "gaussian"   # 'gaussian' | 'fourier' | 'none'
    num_3d_kernels: int = 128
    # heads
    num_dist_bins: int = 256
    # execution
    compute_dtype: str = "float32"    # 'float32' | 'bfloat16'
    # remat: the encoder recomputes the inner layers (every layer under
    # IndivConfig) in the backward (torch.utils.checkpoint) when gradients
    # are on. What the checkpoint saves besides its inputs (ops/remat.py):
    #   'none'   - nothing (full recompute, least memory)
    #   'dots'   - every matrix product's output
    #   'tri_a'  - the plain path's N^3 gated triplet weights
    #   'proj'   - the N^2 triplet projections q, k, v, bias, gate
    #   'tri_va' - 'proj' and the dense kernel's output (its replay then
    #              launches no forward kernel)
    # use_scan is tgt_tpu's compile knob and has no effect in the port's
    # Python layer loop.
    remat: bool = False
    remat_policy: str = "none"
    use_scan: bool = True
    # Triplet core: 'dense' = the hand-written CUDA kernels on every bucket
    # (ops/kernels/triplet_dense.py for the attention variants, with
    # triplet_dropout in the kernels; ops/kernels/triplet_aggregate.py for
    # the aggregate ones); False = the plain PyTorch einsum path; True =
    # tgt_tpu's legacy fused pair (ops/kernels/triplet_attention.py) for the
    # attention variants, which takes the plain path, with a warning, when
    # triplet dropout is on in training; the aggregate variants take their
    # plain path for it, as tgt_tpu does.
    use_pallas: object = False
    # tgt_tpu's measured TPU crossover for its dense kernel. Parsed so
    # configs load; the port does not read them (no TPU crossover applies).
    dense_min_nodes: int = 48
    dense_min_exact_nodes: int = 32

    @property
    def triplet_enabled(self) -> bool:
        th = self.triplet_heads
        return max(th) > 0 if isinstance(th, tuple) else th > 0

    @property
    def has_indiv(self) -> bool:
        """True if any field carries a per-layer tuple (IndivConfig)."""
        return any(isinstance(getattr(self, f), tuple) for f in INDIV_FIELDS)

    def layer_cfg(self, i: int) -> "TGTConfig":
        """Scalar config of layer i: each per-layer tuple gives its i-th
        entry (reference get_layer_kwargs, encoder.py:51-56)."""
        kw = {}
        for f in INDIV_FIELDS:
            v = getattr(self, f)
            if isinstance(v, tuple):
                if len(v) != self.model_height:
                    raise ValueError(
                        f"IndivConfig field {f} has {len(v)} entries for "
                        f"{self.model_height} layers")
                kw[f] = v[i]
        return self.replace(**kw) if kw else self

    def drop_path_rate(self, i: int) -> float:
        """Linear stochastic-depth ramp (reference: encoder.py:57-58) —
        unless drop_path is itself per-layer, which bypasses the ramp."""
        if isinstance(self.drop_path, tuple):
            return self.drop_path[i]
        if self.model_height <= 1:
            return 0.0
        return self.drop_path * i / (self.model_height - 1)

    def layer_updates(self, i: int) -> Tuple[bool, bool]:
        """(node_update, edge_update) for layer i (reference: encoder.py:62-76)."""
        last = i == self.model_height - 1
        node_update = not (last and not self.node_ended)
        if self.egt_simple:
            edge_update = False
        else:
            edge_update = not (last and not self.edge_ended)
        return node_update, edge_update

    def replace(self, **kw) -> "TGTConfig":
        return dataclasses.replace(self, **kw)
