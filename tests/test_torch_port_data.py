"""tgt_torch's PCQM data layer against tgt_tpu's (CPU).

- ``write_synthetic_dataset``: both packages write equal tables;
- ``PCQM4Mv2Dataset``: equal rows on ``train``, ``valid-3d``,
  ``train+valid`` and two ``cache_range_fn`` shards, ``sizes`` included
  (-1 outside a shard), with the Coords columns and the structural
  transform;
- bins: pack and unpack equal, and a bins parquet written by either
  package's ``predict_and_save`` layout joins through the other's ``Bins``
  column;
- ``SizeBucketedTrainSampler`` and ``DistributedTestSampler``: equal index
  lists over epochs 0 and 1 and world sizes 1 and 2.
"""
import json

import numpy as np
import pytest
import torch

pytest.importorskip("pyarrow")

from tgt_tpu.data import bins as jbins
from tgt_tpu.data import loader as jloader
from tgt_tpu.data import pcqm as jpcqm
from tgt_tpu.data.prepare import write_synthetic_dataset as jwrite
from tgt_tpu.data.structural import AddStructuralData as JaxStructural
from tgt_torch.data import bins, loader, pcqm
from tgt_torch.data.prepare import write_synthetic_dataset
from tgt_torch.data.structural import AddStructuralData

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    port = tmp_path_factory.mktemp("port")
    ref = tmp_path_factory.mktemp("ref")
    write_synthetic_dataset(str(port), num_samples=40, max_nodes=12, seed=3)
    jwrite(str(ref), num_samples=40, max_nodes=12, seed=3)
    return str(port), str(ref)


def assert_rows_equal(got, want, where):
    assert set(got) == set(want), where
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                      err_msg=f"{where}: {k}")


@pytest.mark.parametrize("name", ["records.parquet", "dft_coords.parquet",
                                  "rdkit_coords.parquet"])
def test_synthetic_tables_equal(dirs, name):
    import pyarrow.parquet as pq
    port, ref = dirs
    assert pq.read_table(f"{port}/{name}").equals(pq.read_table(f"{ref}/{name}"))


def test_synthetic_splits_equal(dirs):
    port, ref = dirs
    with np.load(f"{port}/splits.npz") as a, np.load(f"{ref}/splits.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


SHARDS = {"whole": None, "shard 0 of 2": lambda n: (0, n // 2),
          "shard 1 of 2": lambda n: (n // 2, n)}


@pytest.mark.parametrize("split,shard", [
    ("train", "whole"), ("valid-3d", "whole"), ("train+valid", "whole"),
    ("train", "shard 0 of 2"), ("train", "shard 1 of 2")])
def test_dataset_rows_match(dirs, split, shard):
    port, _ = dirs
    got = pcqm.PCQM4Mv2Dataset(
        split, port, return_idx=True, cache_range_fn=SHARDS[shard],
        transforms=[AddStructuralData()],
        additional_columns=[pcqm.Coords("rdkit"), pcqm.Coords("dft")])
    want = jpcqm.PCQM4Mv2Dataset(
        split, port, return_idx=True, cache_range_fn=SHARDS[shard],
        transforms=[JaxStructural()],
        additional_columns=[jpcqm.Coords("rdkit"), jpcqm.Coords("dft")])
    assert len(got) == len(want) and got.index_offset == want.index_offset
    np.testing.assert_array_equal(got.sizes, want.sizes)
    if shard != "whole":
        assert (got.sizes < 0).sum() == len(got) - got.records.num_rows > 0
    assert got.max_nodes_index == want.max_nodes_index
    for i in range(got.index_offset, got.index_offset + got.records.num_rows):
        assert_rows_equal(got[i], want[i], f"{split} row {i}")


@pytest.mark.parametrize("n,s,num_bins", [(1, 1, 8), (7, 3, 256),
                                          (12, 2, 300)])
def test_bins_pack_unpack_equal(n, s, num_bins):
    rs = np.random.RandomState(n)
    assert bins.bins_dtype(num_bins) == jbins.bins_dtype(num_bins)
    b = rs.randint(0, num_bins, (s, n, n)).astype(bins.bins_dtype(num_bins))
    np.testing.assert_array_equal(bins.flat_triu_indices(n),
                                  jbins.flat_triu_indices(n))
    packed = bins.pack_bins_multi(b)
    np.testing.assert_array_equal(packed, jbins.pack_bins_multi(b))
    np.testing.assert_array_equal(bins.pack_bins(b[0]), jbins.pack_bins(b[0]))
    np.testing.assert_array_equal(bins.unpack_bins_multi(packed, n),
                                  jbins.unpack_bins_multi(packed, n))
    np.testing.assert_array_equal(bins.unpack_bins(packed[0], n),
                                  jbins.unpack_bins(packed[0], n))


def write_bins(path, rows, s, num_bins, pack, rs):
    """A bins{S} directory in ``predict_and_save``'s layout, written with
    one package's ``pack_bins_multi``; returns the unpacked originals."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    (path / "data").mkdir(parents=True)
    originals, idxs, packed = {}, [], []
    for row in rows:
        n = row["num_nodes"]
        b = np.triu(rs.randint(0, num_bins, (s, n, n)), 1).astype(
            bins.bins_dtype(num_bins))
        originals[row["idx"]] = b
        idxs.append(row["idx"])
        packed.append(pack(b).reshape(-1))
    pq.write_table(pa.Table.from_pydict({"idx": np.asarray(idxs),
                                         "bins": packed}),
                   path / "data" / "val_000.parquet")
    with open(path / "meta.json", "w") as f:
        json.dump({"num_samples": s, "num_bins": num_bins, "range_bins": 8}, f)
    return originals


@pytest.mark.parametrize("writer", ["port", "tgt_tpu"])
def test_bins_parquet_joins_through_the_other_package(dirs, tmp_path, writer):
    port, _ = dirs
    s, num_bins = 3, 256
    rows = [r for r in pcqm.PCQM4Mv2Dataset("valid", port, return_idx=True)
            .records.to_pylist()]
    pack = bins.pack_bins_multi if writer == "port" else jbins.pack_bins_multi
    originals = write_bins(tmp_path / "bins3", rows, s, num_bins, pack,
                           np.random.RandomState(5))
    reader, column = ((jpcqm.PCQM4Mv2Dataset, jpcqm.Bins) if writer == "port"
                      else (pcqm.PCQM4Mv2Dataset, pcqm.Bins))
    assert pcqm.read_bins_meta(str(tmp_path / "bins3"))["num_samples"] == s
    ds = reader("valid", port, return_idx=True,
                additional_columns=[column(str(tmp_path / "bins3"), s)])
    for i in range(ds.index_offset, ds.index_offset + len(ds)):
        row = ds[i]
        np.testing.assert_array_equal(
            row["dist_bins"], originals[row["idx"]].astype(np.float32))


SIZES = np.random.RandomState(0).randint(4, 50, size=45)


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("rank,world_size", [(0, 1), (0, 2), (1, 2)])
def test_size_bucketed_sampler_matches(epoch, rank, world_size):
    args = (SIZES, 8, [16, 24, 32, 48])
    got = loader.SizeBucketedTrainSampler(*args, rank=rank,
                                          world_size=world_size, seed=4)
    want = jloader.SizeBucketedTrainSampler(*args, rank=rank,
                                            world_size=world_size, seed=4)
    got.set_epoch(epoch)
    want.set_epoch(epoch)
    assert list(got) == list(want) and len(got) == len(want)


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("rank,world_size", [(0, 1), (0, 2), (1, 2)])
def test_test_sampler_matches(epoch, rank, world_size):
    got = loader.DistributedTestSampler(45, 8, rank=rank,
                                        world_size=world_size)
    want = jloader.DistributedTestSampler(45, 8, rank=rank,
                                          world_size=world_size)
    # the test sampler has no epoch: every epoch yields the same batches
    assert list(got) == list(want) == list(got) and len(got) == len(want)


def test_size_bucketed_sampler_rejects_out_of_shard_sizes():
    sizes = np.full(20, -1)
    sizes[:10] = 9
    with pytest.raises(ValueError, match="-1"):
        list(loader.SizeBucketedTrainSampler(sizes, 4, [16], rank=1,
                                             world_size=2))
