"""tgt_torch's native data-preparation library (csrc/tgt_native.cpp through
``tgt_torch.data._native``) against the port's numpy code and tgt_tpu's
binding (CPU).

- the library is built from csrc/tgt_native.cpp into ``tgt_torch/_build/``
  at first use, and the build writes nothing under ``tgt_tpu/``;
- the five functions (``floyd_warshall``, ``preprocess_graph``,
  ``pack_bins_multi``, ``unpack_bins_multi``, ``stack_with_pad``) are bitwise
  equal to the port's numpy counterparts and to tgt_tpu's native and numpy
  ones over 240 seeded random graphs: disconnected ones (hop 510), one
  atom, no edges, and N = 56;
- ``structural.backend()`` says which path ran: 'native' with a compiler,
  'numpy' (warned once) without one; a compiler that fails raises with its
  output instead of falling back.
"""
import os
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from tgt_tpu.data import bins as jbins
from tgt_tpu.data import collate as jcollate
from tgt_tpu.data import structural as jstructural
from tgt_torch.data import _native, bins, collate, structural

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_GRAPHS = 240
CHUNKS = 4


@pytest.fixture(scope="module")
def jnative():
    """tgt_tpu's binding; its library is built in place by the first
    process that imports it, so a concurrent build may be read half
    written: try again."""
    for _ in range(5):
        try:
            from tgt_tpu.data import _native as mod
            return mod
        except (ImportError, OSError):
            time.sleep(2)
    from tgt_tpu.data import _native as mod
    return mod


def random_graph(seed):
    """A seeded random graph. Seeds 0-2 are the edge cases (one atom; 20
    atoms without edges; a path of 56), the others have 2-56 atoms, some
    in several components."""
    rs = np.random.RandomState(seed)
    if seed == 0:
        n, pairs = 1, []
    elif seed == 1:
        n, pairs = 20, []
    elif seed == 2:
        n, pairs = 56, [(i, i + 1) for i in range(55)]
    else:
        n = int(rs.randint(2, 57))
        parts = int(rs.randint(1, 4))           # components
        cut = np.sort(rs.choice(np.arange(1, n), min(parts - 1, n - 1),
                                replace=False)) if n > 1 else []
        starts = [0, *cut]
        pairs = []
        for lo, hi in zip(starts, [*cut, n]):
            pairs += [(int(rs.randint(lo, j)), j) for j in range(lo + 1, hi)]
            for _ in range(int(0.2 * (hi - lo))):
                i, j = rs.randint(lo, hi, 2)
                if i != j:
                    pairs.append((int(min(i, j)), int(max(i, j))))
        pairs = sorted(set(pairs))
    edges = np.asarray(pairs + [(j, i) for i, j in pairs],
                       np.int64).reshape(-1, 2)
    ef = rs.randint(0, 5, size=(len(pairs), 3))
    return (n, edges, rs.randint(0, 60, size=(n, 9)).astype(np.int64),
            np.concatenate([ef, ef]).astype(np.int64).reshape(-1, 3))


def chunk(c):
    return range(c * N_GRAPHS // CHUNKS, (c + 1) * N_GRAPHS // CHUNKS)


def assert_same(got, want, where):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    np.testing.assert_array_equal(got, want, err_msg=where)


def tgt_tpu_files():
    """The files under tgt_tpu/, but for its bytecode and the library
    tgt_tpu's own binding builds in place."""
    return sorted(str(p) for p in (REPO / "tgt_tpu").rglob("*")
                  if "__pycache__" not in p.parts
                  and p.name != "libtgt_native.so")


def test_library_is_built_into_tgt_torch_build(tmp_path, monkeypatch):
    _native.library()
    path = _native.library_path()
    assert path.parent == REPO / "tgt_torch" / "_build"
    assert path.exists() and path.name.startswith("libtgt_native-")
    # a fresh build (into another directory) adds no file under tgt_tpu/
    before = tgt_tpu_files()
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    built = _native.build()
    assert built.parent == tmp_path / "_build" and built.exists()
    assert tgt_tpu_files() == before
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_the_graphs_cover_the_edge_cases():
    sizes, unreachable = [], 0
    for seed in range(N_GRAPHS):
        n, edges, _, _ = random_graph(seed)
        sizes.append(n)
        adj = np.zeros((n, n), np.int16)
        if len(edges):
            adj[edges[:, 0], edges[:, 1]] = 1
        unreachable += int((structural.floyd_warshall(adj) == 510).any())
    assert sizes[0] == 1 and len(random_graph(1)[1]) == 0
    assert max(sizes) == 56 and unreachable > 30


@pytest.mark.parametrize("c", range(CHUNKS))
def test_preprocess_graph(c, jnative):
    for seed in chunk(c):
        g = random_graph(seed)
        want = structural.preprocess_graph_numpy(*g)
        for name, got in (("native", _native.preprocess_graph(*g)),
                          ("wired", structural.preprocess_graph(*g)),
                          ("tgt_tpu native", jnative.preprocess_graph(*g))):
            for a, b, what in zip(got, want, ("nodes", "dist", "featm")):
                assert_same(a, b, f"graph {seed} {name} {what}")


@pytest.mark.parametrize("c", range(CHUNKS))
def test_floyd_warshall(c, jnative):
    for seed in chunk(c):
        n, edges, _, _ = random_graph(seed)
        adj = np.zeros((n, n), np.int16)
        if len(edges):
            adj[edges[:, 0], edges[:, 1]] = 1
        want = structural.floyd_warshall(adj)
        assert_same(_native.floyd_warshall(adj), want, f"graph {seed}")
        assert_same(jnative.floyd_warshall(adj), want, f"graph {seed}")
        assert_same(jstructural.floyd_warshall(adj), want, f"graph {seed}")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("c", range(CHUNKS))
def test_pack_and_unpack_bins(c, dtype, jnative):
    for seed in chunk(c):
        n = random_graph(seed)[0]
        rs = np.random.RandomState(seed)
        b = rs.randint(0, np.iinfo(dtype).max, size=(3, n, n)).astype(dtype)
        packed = bins.pack_bins_multi(b)
        for got in (_native.pack_bins_multi(b), jnative.pack_bins_multi(b),
                    jbins.pack_bins_multi(b)):
            assert_same(got, packed, f"pack {seed}")
        unpacked = bins.unpack_bins_multi(packed, n)
        for got in (_native.unpack_bins_multi(packed, n),
                    jnative.unpack_bins_multi(packed, n),
                    jbins.unpack_bins_multi(packed, n)):
            assert_same(got, unpacked, f"unpack {seed}")


@pytest.mark.parametrize("c", range(CHUNKS))
def test_stack_with_pad(c, jnative):
    for seed in chunk(c):
        rows = [structural.preprocess_graph_numpy(*random_graph(s))
                for s in range(seed, seed + 4)]
        for k, pad_to in ((0, {0: 56}), (1, {0: 56, 1: 56}), (2, None)):
            arrays = [r[k] for r in rows]
            want = collate.stack_with_pad(arrays, pad_to)
            for got in (_native.stack_with_pad(arrays, pad_to),
                        jnative.stack_with_pad(arrays, pad_to),
                        jcollate.stack_with_pad(arrays, pad_to)):
                assert_same(got, want, f"rows {seed}+4, part {k}")


@pytest.fixture
def fresh_backend(tmp_path, monkeypatch):
    """The structural transform's choice of path made anew, against an
    empty build directory; restored (and made anew) after the test."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    _native.library.cache_clear()
    structural._native_module.cache_clear()
    yield
    monkeypatch.undo()
    _native.library.cache_clear()
    structural._native_module.cache_clear()


def test_backend_is_native_with_a_compiler(fresh_backend, tmp_path):
    g = random_graph(7)
    assert structural.backend() == "native"
    assert list((tmp_path / "_build").glob("libtgt_native-*.so"))
    for a, b in zip(structural.preprocess_graph(*g),
                    structural.preprocess_graph_numpy(*g)):
        assert_same(a, b, "native")


def test_backend_is_numpy_without_a_compiler(fresh_backend, monkeypatch):
    monkeypatch.setattr(_native, "compiler", lambda: None)
    g = random_graph(8)
    with pytest.warns(RuntimeWarning, match="numpy version"):
        assert structural.backend() == "numpy"
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # warned once only
        got = structural.preprocess_graph(*g)
        assert structural.backend() == "numpy"
    for a, b in zip(got, structural.preprocess_graph_numpy(*g)):
        assert_same(a, b, "numpy")


def test_a_failing_compiler_raises(fresh_backend, tmp_path, monkeypatch):
    cxx = tmp_path / "broken-g++"
    cxx.write_text("#!/bin/sh\necho 'broken compiler: no code' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(_native, "COMPILER", str(cxx))
    with pytest.raises(RuntimeError, match="broken compiler: no code"):
        structural.preprocess_graph(*random_graph(9))
    with pytest.raises(RuntimeError, match="broken compiler"):
        structural.backend()
    assert not list((tmp_path / "_build").glob("*"))
