"""The port's span recorder (``tgt_torch.utils.tracing``) and its spans in
the serving, trainer and data layers (CPU, float32).

- with no profiler running a span records nothing and enters no
  ``record_function``;
- under torch's profiler the rows carry their names, ids, parents and
  attributes, and a span's ``t0``/``t1`` bracket its profiler range on the
  profiler's own clock;
- a span on another thread (the data loader's) is recorded and not
  emitted to the profiler;
- ``DistancePredictor.predict`` under ``mc_mode`` map and vmap: the span
  tree of a request and the rows of each forward, counted by hand;
- ``Trainer.train_epoch``: the step tree;
- the outputs and the parameters bitwise equal with the profiler on and
  off;
- the operator's profiling tool: the span table's total and self times and
  the device busy time as a union of intervals.
"""
import collections
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tgt_torch import profiling as tool
from tgt_torch import serving
from tgt_torch.data.synthetic import make_molecule
from tgt_torch.models.heads import make_model
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.schemes import get_scheme
from tgt_torch.serving import DistancePredictor
from tgt_torch.training.harness import Trainer
from tgt_torch.utils import tracing

torch.set_num_threads(1)

SMALL = dict(node_width=16, edge_width=32, num_heads=4, model_height=2,
             triplet_heads=4, num_dist_bins=8, triplet_type="attention",
             use_pallas=False, source_dropout=0.2, node_act_dropout=0.1,
             edge_act_dropout=0.1, triplet_dropout=0.2)
SIZES = (5, 11, 7)          # at batch 2: [5, 7] at bucket 8, [11] at 16
DRAWS = 3
TRAIN = dict(scheme="pcqm.dist_pred", dataset_source="synthetic",
             synth_train_samples=8, synth_max_nodes=10, batch_size=4,
             global_batch_size=4, buckets=[12], model_height=2,
             node_width=16, edge_width=16, num_heads=4, triplet_heads=4,
             triplet_type="attention", num_dist_bins=8, max_lr=1e-3,
             lr_warmup_steps=1, lr_total_steps=100)


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def molecules(sizes=SIZES):
    rs = np.random.RandomState(0)
    out = []
    for n in sizes:
        m = make_molecule(rs, int(n))
        m["coords"] = m.pop("rdkit_coords")
        for k in ("dft_coords", "target"):
            m.pop(k)
        out.append(m)
    return out


def predictor(mode, seed=4):
    cfg = TGTConfig(**SMALL)
    model = make_model("distance", cfg, device="cpu", seed=0)
    return DistancePredictor(model, cfg, mc_samples=DRAWS, batch_size=2,
                             buckets=(8, 16), seed=seed, device="cpu",
                             mc_mode=mode)


def by_name(rows, name):
    return [r for r in rows if r["name"] == name]


# -- the recorder -------------------------------------------------------------

def test_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.span("serve.forward", request=1) as row:
        assert row is None
    assert tracing.span("a") is tracing.span("b")     # one shared context
    serving_rows = predictor("vmap").predict(molecules((5,)))
    assert serving_rows.shape[0] == 1
    assert tracing.recorded() == []


def test_rows_under_the_profiler_bracket_their_ranges():
    with cpu_profile() as prof:
        with tracing.span("outer", step=7) as outer:
            outer["late"] = "added"
            with tracing.span("inner", rows=3):
                torch.ones(4).sum()
        with tracing.span("after"):
            pass
    rows = tracing.recorded()
    assert [r["name"] for r in rows] == ["inner", "outer", "after"]
    inner, outer, after = rows
    assert outer["parent"] is None and after["parent"] is None
    assert inner["parent"] == outer["id"]
    assert len({r["id"] for r in rows}) == 3
    assert outer["step"] == 7 and outer["late"] == "added"
    assert inner["rows"] == 3 and inner["step"] == 7    # a shared id
    assert "step" not in after
    assert {r["thread"] for r in rows} == {threading.get_ident()}
    for r in rows:
        assert r["t0"] <= r["t1"]
    assert outer["t0"] <= inner["t0"] <= inner["t1"] <= outer["t1"]
    # the profiler's absolute times of each span's range
    ranges = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(tracing.PREFIX)}
    assert set(ranges) == {tracing.PREFIX + n for n in
                           ("outer", "inner", "after")}
    for r in rows:
        start, end = ranges[tracing.PREFIX + r["name"]]
        assert r["t0"] <= start <= end <= r["t1"], r["name"]
    # reading clears nothing; a copy is returned
    rows[0]["name"] = "changed"
    assert [r["name"] for r in tracing.recorded()] == ["inner", "outer",
                                                       "after"]
    tracing.clear()
    assert tracing.recorded() == []


def test_a_loader_thread_span_is_recorded_and_not_emitted(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name):
        entered.append((name, threading.get_ident()))
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)

    def loader():
        with tracing.span("data.collate", rows=2):
            with tracing.span("data.transform", atoms=5):
                pass

    with cpu_profile() as prof:
        with tracing.span("train.input_wait", step=0):
            t = threading.Thread(target=loader)
            t.start()
            t.join()
    rows = {r["name"]: r for r in tracing.recorded()}
    assert set(rows) == {"data.collate", "data.transform",
                         "train.input_wait"}
    main = threading.get_ident()
    assert rows["data.collate"]["thread"] != main
    # parents are per thread: the loader's outermost span has none
    assert rows["data.collate"]["parent"] is None
    assert rows["data.transform"]["parent"] == rows["data.collate"]["id"]
    assert entered == [(tracing.PREFIX + "train.input_wait", main)]
    names = {e.name for e in prof.events()}
    assert tracing.PREFIX + "train.input_wait" in names
    assert not any(n.startswith(tracing.PREFIX + "data.") for n in names)


def test_the_buffer_keeps_the_newest_rows(monkeypatch):
    monkeypatch.setattr(tracing, "_rows", collections.deque(maxlen=3))
    with cpu_profile():
        for i in range(5):
            with tracing.span("s", i=i):
                pass
    assert [r["i"] for r in tracing.recorded()] == [2, 3, 4]


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["map", "vmap"])
def test_a_request_s_span_tree_and_rows(mode):
    pred = predictor(mode)
    with cpu_profile():
        pred.predict(molecules())
    rows = tracing.recorded()
    (top,) = by_name(rows, "serve.predict")
    assert top["parent"] is None and top["molecules"] == 3
    request = top["request"]
    serve = [r for r in rows if r["name"].startswith("serve.")]
    assert {r["request"] for r in serve} == {request}
    children = [r["name"] for r in rows if r["parent"] == top["id"]]
    assert children == ["serve.prepare", "serve.collate", "serve.forward",
                        "serve.collate", "serve.forward", "serve.copy_back",
                        "serve.scatter"]
    (prep,) = by_name(rows, "serve.prepare")
    transforms = by_name(rows, "data.transform")
    assert sorted(r["atoms"] for r in transforms) == sorted(SIZES)
    assert {r["parent"] for r in transforms} == {prep["id"]}
    collates = by_name(rows, "serve.collate")
    assert [(c["bucket"], c["rows_real"], c["rows"]) for c in collates] == \
        [(8, 2, 2), (16, 1, 2)]
    inner = by_name(rows, "data.collate")
    assert [(r["parent"], r["rows"], r["bucket"]) for r in inner] == \
        [(c["id"], c["rows_real"], c["bucket"]) for c in collates]
    forwards = by_name(rows, "serve.forward")
    assert [(f["schedule"], f["draws"], f["rows_real"], f["rows_run"])
            for f in forwards] == [(mode, DRAWS, 2 * DRAWS, 2 * DRAWS),
                                   (mode, DRAWS, 1 * DRAWS, 2 * DRAWS)]
    assert {r["request"] for r in transforms + inner} == {request}


def test_an_inner_call_keeps_the_open_request_id():
    """As a two-stage request's inner calls do."""
    pred = predictor("map")
    with cpu_profile():
        with tracing.span("serve.predict") as outer:
            serving._request(outer, [None])
            pred.predict_bins(molecules((5,)))
        pred.predict(molecules((5,)))
    tops = by_name(tracing.recorded(), "serve.predict")
    request = outer["request"]
    assert [t["request"] for t in tops] == [request, request, request + 1]
    assert tops[0]["parent"] == tops[1]["id"]


def test_serving_outputs_equal_with_the_profiler_on_and_off():
    mols = molecules()
    off = predictor("vmap").predict(mols)
    with cpu_profile():
        on = predictor("vmap").predict(mols)
    np.testing.assert_array_equal(on, off)


# -- training -----------------------------------------------------------------

def trained(tmp_path, traced: bool):
    scheme = get_scheme(TRAIN["scheme"])(
        dict(TRAIN, save_path_prefix=str(tmp_path)))
    trainer = Trainer(scheme, device="cpu")
    state = trainer.init_state(seed=0)
    loader = scheme.train_loader(0, 0, 1)
    if traced:
        with cpu_profile():
            state, logs, _ = trainer.train_epoch(state, loader)
    else:
        state, logs, _ = trainer.train_epoch(state, loader)
    return state, logs


def test_an_epoch_s_step_tree_and_equal_parameters(tmp_path):
    off, logs_off = trained(tmp_path / "off", traced=False)
    assert tracing.recorded() == []
    on, logs_on = trained(tmp_path / "on", traced=True)
    for (k, a), b in zip(off["model"].state_dict().items(),
                         on["model"].state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    assert logs_on == logs_off

    rows = tracing.recorded()
    main = threading.get_ident()
    steps = by_name(rows, "train.step")
    assert [s["step"] for s in steps] == [0, 1]
    for s in steps:
        under = [r["name"] for r in rows if r["parent"] == s["id"]]
        assert under == ["train.grad", "train.update"]
        assert {r["step"] for r in rows if r["parent"] == s["id"]} == \
            {s["step"]}
    assert [r["step"] for r in by_name(rows, "train.input_wait")] == [0, 1, 2]
    preps = by_name(rows, "train.batch_prep")
    assert [(p["step"], p["rows"], p["rows_real"], p["bucket"])
            for p in preps] == [(0, 4, 4, 12), (1, 4, 4, 12)]
    assert len(by_name(rows, "train.drain")) == 3
    main_spans = [r for r in rows if r["name"].startswith("train.")]
    assert all(r["thread"] == main and r["parent"] in
               {None} | {s["id"] for s in steps} for r in main_spans)
    collates = by_name(rows, "data.collate")
    assert len(collates) == 2
    assert all(c["thread"] != main and c["rows"] == 4 and c["bucket"] == 12
               for c in collates)


# -- the operator's tool ------------------------------------------------------

def test_span_table_total_and_self_time():
    ms = 1_000_000
    rows = [
        {"name": "train.grad", "id": 2, "parent": 1, "t0": 0, "t1": 3 * ms},
        {"name": "train.update", "id": 3, "parent": 1, "t0": 3 * ms,
         "t1": 4 * ms},
        {"name": "train.step", "id": 1, "parent": None, "t0": 0,
         "t1": 5 * ms},
        {"name": "train.grad", "id": 5, "parent": 4, "t0": 10 * ms,
         "t1": 11 * ms},
        {"name": "train.step", "id": 4, "parent": None, "t0": 10 * ms,
         "t1": 13 * ms},
    ]
    table = {t["span"]: t for t in tool.span_table(rows, per=2)}
    assert [t["span"] for t in tool.span_table(rows, per=2)] == \
        ["train.step", "train.grad", "train.update"]
    assert table["train.step"] == {"span": "train.step", "calls_per_step": 1,
                                   "host_ms_per_step": 4.0,
                                   "self_ms_per_step": 1.5}
    assert table["train.grad"]["host_ms_per_step"] == 2.0
    assert table["train.grad"]["self_ms_per_step"] == 2.0
    assert table["train.update"]["calls_per_step"] == 0.5


def test_device_busy_is_the_union_of_the_operations():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, start, end, device=cuda, annotation=False):
        return SimpleNamespace(name=name, device_type=device,
                               is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [ev("k1", 0, 10), ev("k2", 5, 15), ev("k3", 20, 30),
              ev("k4", 22, 25), ev("host", 0, 100, device=cpu),
              ev("tgt_torch.serve.forward", 0, 100),
              ev("user range", 40, 90, annotation=True)]
    # (15 + 10) us: the overlap counted once, annotations not at all
    assert tool.device_busy_s(events) == pytest.approx(25e-6)
