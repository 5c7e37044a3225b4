"""PCQM4Mv2 dataset over pyarrow parquet, with pluggable columns
(counterpart of tgt_tpu/data/pcqm.py: the same files give the same rows).

As the reference dataset (lib/data/pcqm/data.py:30-239):
- split indices from ``splits.npz`` with '+'-concatenation ('train+valid'),
- ``records.parquet`` loaded through a pyarrow ``idx``-isin filter pushdown,
- per-rank cache ranges so each data-parallel host only materializes its
  contiguous shard,
- in-RAM row cache, row transforms,
- plugin Columns: Coords (rdkit/dft parquet join), DistInput (dense NxN
  matrix), Bins (packed predicted-distance bins + meta.json).

Used together with data/structural.AddStructuralData and data/collate.
pyarrow is imported when a dataset loads, not with this module.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tgt_torch.data.bins import unpack_bins_multi


class Column:
    """A pluggable extra column joined onto the records table by idx."""

    path: Optional[str] = None
    verbose: int = 0

    def load_data(self, records, index_filter):
        raise NotImplementedError

    def get_row(self, records, row_id: int, row: Dict) -> Dict:
        raise NotImplementedError

    def default_path(self, dataset_path: str) -> None:
        if self.path is None:
            self.path = dataset_path


class Coords(Column):
    """3D coordinates from ``{name}_coords.parquet`` (reference data.py:163-189)."""

    def __init__(self, name: str, path: Optional[str] = None,
                 coords_file: Optional[str] = None, verbose: int = 0):
        self.name = name
        self.path = path
        self.coords_file = coords_file
        self.verbose = verbose

    def load_data(self, records, index_filter):
        import pyarrow.dataset as pds
        f = self.coords_file or os.path.join(self.path,
                                             f"{self.name}_coords.parquet")
        tbl = pds.dataset(f).to_table(filter=index_filter)
        if not tbl["idx"].equals(records["idx"]):
            raise ValueError(f"idx mismatch joining {self.name}_coords")
        return records.add_column(records.num_columns, f"{self.name}_coords",
                                  tbl[f"{self.name}_coords"])

    def get_row(self, records, row_id, row):
        row[f"{self.name}_coords"] = (
            records[f"{self.name}_coords"][row_id].values.to_numpy()
            .reshape(-1, 3))
        return row


class DistInput(Column):
    """Dense precomputed distance matrices (reference data.py:192-211)."""

    def __init__(self, path: str, verbose: int = 0):
        self.path = path
        self.verbose = verbose

    def load_data(self, records, index_filter):
        import pyarrow.dataset as pds
        tbl = pds.dataset(self.path).to_table(filter=index_filter)
        tbl = tbl.sort_by("idx")
        if not tbl["idx"].equals(records["idx"]):
            raise ValueError("idx mismatch joining dist_input")
        return records.add_column(records.num_columns, "dist_input", tbl["dms"])

    def get_row(self, records, row_id, row):
        n = row["num_nodes"]
        row["dist_input"] = (records["dist_input"][row_id].values.to_numpy()
                             .reshape(n, n))
        return row


class Bins(Column):
    """Packed predicted-distance bins (reference data.py:215-239).

    On-disk: parquet shards under ``path/data`` with columns idx, bins
    (S x packed-upper-triangle rows flattened), plus ``path/meta.json``
    with num_samples/num_bins/range_bins.
    """

    def __init__(self, path: str, num_bin_samples: int, verbose: int = 0):
        self.path = path
        self.num_bin_samples = num_bin_samples
        self.verbose = verbose

    def load_data(self, records, index_filter):
        import pyarrow.dataset as pds
        tbl = pds.dataset(os.path.join(self.path, "data")).to_table(
            filter=index_filter)
        tbl = tbl.sort_by("idx")
        if not tbl["idx"].equals(records["idx"]):
            raise ValueError("idx mismatch joining bins")
        return records.add_column(records.num_columns, "dist_bins", tbl["bins"])

    def get_row(self, records, row_id, row):
        n = row["num_nodes"]
        packed = records["dist_bins"][row_id].values.to_numpy()
        packed = packed.reshape(self.num_bin_samples, -1)
        row["dist_bins"] = unpack_bins_multi(packed, n).astype(np.float32)
        return row


def read_bins_meta(path: str) -> Dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


class PCQM4Mv2Dataset:
    """Map-style dataset over records.parquet + splits.npz."""

    def __init__(self, split: str, dataset_path: str,
                 include_node_mask: bool = True,
                 load_data: bool = True,
                 cache_range_fn: Optional[Callable[[int], Tuple[int, int]]] = None,
                 return_idx: bool = False,
                 cache_rows: bool = True,
                 additional_columns: Optional[List[Column]] = None,
                 transforms: Optional[List[Callable]] = None,
                 verbose: int = 0):
        self.split = split
        self.dataset_path = dataset_path
        self.include_node_mask = include_node_mask
        self.cache_range_fn = cache_range_fn
        self.return_idx = return_idx
        self.cache_rows = cache_rows
        self.additional_columns = additional_columns or []
        self.transforms = transforms or []
        self.verbose = verbose
        for col in self.additional_columns:
            col.default_path(dataset_path)
        self._cached_rows = None
        if load_data:
            self.load()

    # -- loading ----------------------------------------------------------
    def load(self) -> None:
        import pyarrow.dataset as pds
        split_file = os.path.join(self.dataset_path, "splits.npz")
        with np.load(split_file) as npz:
            if "+" in self.split:
                indices = np.concatenate([npz[s] for s in self.split.split("+")])
            else:
                indices = npz[self.split]
        self.dataset_length = len(indices)

        if self.cache_range_fn is None:
            start, end = 0, self.dataset_length
        else:
            start, end = self.cache_range_fn(self.dataset_length)
        self.index_offset = start
        self.indices = indices[start:end]
        self.index_filter = pds.field("idx").isin(self.indices)

        records_file = os.path.join(self.dataset_path, "records.parquet")
        self.records = pds.dataset(records_file).to_table(
            filter=self.index_filter)
        if self.records.num_rows != len(self.indices):
            raise ValueError(
                f"loaded {self.records.num_rows} records, expected "
                f"{len(self.indices)}")
        for col in self.additional_columns:
            self.records = col.load_data(self.records, self.index_filter)

    # -- access -----------------------------------------------------------
    @property
    def max_nodes_index(self) -> int:
        num_nodes = self.records["num_nodes"].to_numpy()
        return int(np.argmax(num_nodes)) + self.index_offset

    @property
    def sizes(self) -> np.ndarray:
        """Per-position node counts, indexed by GLOBAL position (full split
        length). With a per-rank cache range only the loaded shard's entries
        are filled (samplers only read their own slice); out-of-shard
        entries are -1 so a future global reader fails loudly (the samplers
        assert non-negative) instead of seeing fake empty molecules."""
        local = self.records["num_nodes"].to_numpy()
        if self.index_offset == 0 and len(local) == self.dataset_length:
            return local
        full = np.full(self.dataset_length, -1, np.int64)
        full[self.index_offset:self.index_offset + len(local)] = local
        return full

    def get_row(self, row_id: int) -> Dict:
        row: Dict = {}
        n = self.records["num_nodes"][row_id].as_py()
        row["num_nodes"] = n
        row["edges"] = (self.records["edges"][row_id].values.to_numpy()
                        .reshape(-1, 2))
        row["node_features"] = (self.records["node_features"][row_id].values
                                .to_numpy().reshape(-1, 9))
        row["edge_features"] = (self.records["edge_features"][row_id].values
                                .to_numpy().reshape(-1, 3))
        target = self.records["target"][row_id].as_py()
        row["target"] = target if target is not None else np.nan
        if self.return_idx:
            row["idx"] = self.records["idx"][row_id].as_py()
        if self.include_node_mask:
            row["node_mask"] = np.ones(n, np.uint8)
        for col in self.additional_columns:
            row = col.get_row(self.records, row_id, row)
        return row

    def __getitem__(self, index: int) -> Dict:
        row_id = index - self.index_offset
        if self.cache_rows:
            if self._cached_rows is None:
                self._cached_rows = [self.get_row(i)
                                     for i in range(self.records.num_rows)]
            item = dict(self._cached_rows[row_id])
        else:
            item = self.get_row(row_id)
        for t in self.transforms:
            item = t(item)
        return item

    def __len__(self) -> int:
        return self.dataset_length
