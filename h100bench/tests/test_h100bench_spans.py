"""The five metrics that read the program's spans: their arithmetic on rows
made by hand, and None where the program's span recorder cannot be
imported (as on a program that has none) or holds no rows."""
from __future__ import annotations

import sys

import pytest

from h100bench import harness
from h100bench.yardstick import spans

MS = 1_000_000          # ns
SERVE = {"mix": {"driver": "serve"}, "cfg": {}}
TRAIN = {"mix": {"driver": "train"}, "cfg": {}}
METRICS = {"serve_host_ms": SERVE, "serve_wait_ms": SERVE,
           "serve_row_fill": SERVE, "train_update_share": TRAIN,
           "data_ms_per_mol.train": TRAIN}


def row(name, id_, parent, t0, t1, **attrs):
    return {"name": name, "id": id_, "parent": parent, "t0": t0 * MS,
            "t1": t1 * MS, "thread": 1, **attrs}


def serving_rows():
    """Two requests: the first of 10 ms with 6 ms of copy back over two
    spans, the second of 20 ms with 4 ms; a forward of 1 real row in 16
    and one of 16 in 16, at 10 draws."""
    return [
        row("serve.prepare", 2, 1, 0, 1, request=0),
        row("serve.forward", 3, 1, 1, 4, request=0, rows_real=10,
            rows_run=160),
        row("serve.copy_back", 4, 1, 4, 8, request=0),
        row("serve.copy_back", 5, 1, 8, 10, request=0),
        row("serve.predict", 1, None, 0, 10, request=0),
        row("serve.forward", 7, 6, 11, 20, request=1, rows_real=160,
            rows_run=160),
        row("serve.predict", 8, 6, 11, 28, request=1),   # an inner call
        row("serve.copy_back", 9, 8, 24, 28, request=1),
        row("serve.predict", 6, None, 10, 30, request=1),
    ]


def training_rows():
    return [
        row("train.grad", 102, 101, 0, 30, step=0),
        row("train.update", 103, 101, 30, 40, step=0),
        row("train.step", 101, None, 0, 40, step=0),
        row("train.grad", 105, 104, 50, 80, step=1),
        row("train.update", 106, 104, 80, 90, step=1),
        row("train.step", 104, None, 50, 100, step=1),
        row("data.transform", 111, 110, 0, 1, atoms=5),
        row("data.transform", 112, 110, 1, 3, atoms=9),
        row("data.transform", 113, 110, 3, 4, atoms=7),
        row("data.collate", 110, None, 0, 6, rows=3),
    ]


def test_serving_arithmetic():
    rows = serving_rows()
    assert spans.serve_host_ms(rows) == pytest.approx(((10 - 6) + (20 - 4))
                                                      / 2)
    assert spans.serve_wait_ms(rows) == pytest.approx((6 + 4) / 2)
    assert spans.serve_row_fill(rows) == pytest.approx(100 * 170 / 320)
    tops = [top["id"] for top, _ in spans.outermost(rows, "serve.predict")]
    assert tops == [1, 6]


def test_training_arithmetic():
    rows = training_rows()
    assert spans.train_update_share(rows) == pytest.approx(100 * 20 / 90)
    assert spans.data_ms_per_molecule(rows) == pytest.approx((4 + 6) / 3)


@pytest.mark.parametrize("fn", [spans.serve_host_ms, spans.serve_wait_ms,
                                spans.serve_row_fill,
                                spans.train_update_share,
                                spans.data_ms_per_molecule])
def test_nothing_to_read(fn):
    assert fn([]) is None


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "h100bench_metric_" + name.replace(".", "_"))


@pytest.fixture
def recorder():
    tracing = pytest.importorskip("tgt_torch.utils.tracing")
    tracing.clear()
    yield tracing
    tracing.clear()


def test_readers_read_the_program_s_rows(recorder, monkeypatch):
    rows = serving_rows() + training_rows()
    monkeypatch.setattr(recorder, "recorded", lambda: [dict(r) for r in rows])
    want = {"serve_host_ms": 10.0, "serve_wait_ms": 5.0,
            "serve_row_fill": 100 * 170 / 320,
            "train_update_share": 100 * 20 / 90,
            "data_ms_per_mol.train": 10 / 3}
    for name, rec in METRICS.items():
        assert _reader(name).read(rec) == pytest.approx(want[name]), name
        other = TRAIN if rec is SERVE else SERVE
        assert _reader(name).read(other) is None, name


@pytest.mark.parametrize("name", sorted(METRICS))
def test_none_without_rows(recorder, name):
    assert _reader(name).read(METRICS[name]) is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_none_without_the_program_s_recorder(monkeypatch, name):
    """As on a program without the module: its import fails."""
    utils = sys.modules.get("tgt_torch.utils")
    if utils is not None:
        monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "tgt_torch.utils.tracing", None)
    assert _reader(name).read(METRICS[name]) is None
