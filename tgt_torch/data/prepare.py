"""Dataset files in the PCQM4Mv2 on-disk format (counterpart of
tgt_tpu/data/prepare.py; ported: ``write_dataset`` and
``write_synthetic_dataset``, which write the same tables as tgt_tpu's).

  records.parquet: idx, num_nodes, edges (flat i,j pairs), node_features
                   (flat, 9/atom), edge_features (flat, 3/bond), target
  {name}_coords.parquet: idx, {name}_coords (flat xyz)
  splits.npz: train / valid / test-dev / train-3d / valid-3d index arrays

The preparation of the real PCQM4Mv2 (OGB SDF and SMILES, RDKit
conformers) needs ogb and rdkit, and its train-3d holdout needs sklearn;
both wait for the rest of ROADMAP.md item 1j.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import numpy as np

from tgt_torch.data.synthetic import make_molecule


def write_dataset(records: Iterable[Dict], out_dir: str,
                  coords_names: Iterable[str] = ("dft",),
                  splits: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write records + coords parquets + splits.npz in the dataset format."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(out_dir, exist_ok=True)
    cols: Dict[str, List] = {"idx": [], "num_nodes": [], "edges": [],
                             "node_features": [], "edge_features": [],
                             "target": []}
    coord_cols = {name: {"idx": [], f"{name}_coords": []}
                  for name in coords_names}
    for i, rec in enumerate(records):
        idx = rec.get("idx", i)
        cols["idx"].append(idx)
        cols["num_nodes"].append(int(rec["num_nodes"]))
        cols["edges"].append(np.asarray(rec["edges"], np.int64)
                             .reshape(-1).tolist())
        cols["node_features"].append(np.asarray(rec["node_features"], np.int64)
                                     .reshape(-1).tolist())
        cols["edge_features"].append(np.asarray(rec["edge_features"], np.int64)
                                     .reshape(-1).tolist())
        t = rec.get("target")
        cols["target"].append(None if t is None or
                              (isinstance(t, float) and np.isnan(t)) else
                              float(t))
        for name in coords_names:
            key = f"{name}_coords"
            if key in rec:
                coord_cols[name]["idx"].append(idx)
                coord_cols[name][key].append(
                    np.asarray(rec[key], np.float32).reshape(-1).tolist())

    pq.write_table(pa.table(cols), os.path.join(out_dir, "records.parquet"))
    for name in coords_names:
        if coord_cols[name]["idx"]:
            pq.write_table(pa.table(coord_cols[name]),
                           os.path.join(out_dir, f"{name}_coords.parquet"))
    if splits is not None:
        np.savez(os.path.join(out_dir, "splits.npz"),
                 **{k: np.asarray(v) for k, v in splits.items()})


def write_synthetic_dataset(out_dir: str, num_samples: int = 64,
                            max_nodes: int = 16, seed: int = 0) -> None:
    """A synthetic dataset in the exact on-disk format: the first 75% of
    the molecules are ``train`` (its last eighth ``valid-3d``, the rest
    ``train-3d``), the others ``valid`` and ``test-dev``."""
    rs = np.random.RandomState(seed)
    records = []
    for i in range(num_samples):
        n = int(rs.randint(4, max_nodes + 1))
        records.append({**make_molecule(rs, n), "idx": i})
    idx = np.arange(num_samples)
    n_train = int(num_samples * 0.75)
    train = idx[:n_train]
    valid = idx[n_train:]
    hold = max(1, n_train // 8)
    splits = {
        "train": train, "valid": valid, "test-dev": valid,
        "train-3d": train[:-hold], "valid-3d": train[-hold:],
    }
    write_dataset(records, out_dir, coords_names=("dft", "rdkit"),
                  splits=splits)
