"""The harness as data: every cell, configuration, traffic mix, driver,
limit and metric file found by the names BENCHMARK.json gives, its names
and units within the benchmark's character rules; each traffic generator
and driver run at a tiny preset on the CPU with no device metric written;
a run without a card refused; a metric added as one file and one entry
picked up; and a roofline's marked entry points credited with all that
their calls launch."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from h100bench import generator, harness
from h100bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]


def test_every_file_found_by_name():
    bench = harness.Bench()
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert bench.config(c["name"])["config"]["scheme"]
    for w in SPEC["workloads"]:
        mix = bench.mix(w["traffic"])
        assert (harness.HERE / "drivers" / f"{mix['driver']}.py").is_file()
        assert all("limit" in v for v in bench.limits(w["name"]).values())
        assert bench.per_layer(w["name"]) and bench.end_to_end(w["name"])
    for m in SPEC["per_layer"]:
        reader = harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py", "m")
        assert reader.read({"mix": {"driver": "none"}, "cfg": {}}) is None


@pytest.mark.parametrize("mix", ["train_pcqm", "serve_single_vmap"])
def test_traffic_same_work_for_every_seed(mix):
    spec = harness.Bench().mix(mix)
    a, b = generator.Traffic(spec, 1), generator.Traffic(spec, 2 ** 31 + 7)
    k = spec["pool_items"]
    assert sorted(map(sorted, (a.sizes(i) for i in range(k)))) == \
        sorted(map(sorted, (b.sizes(i) for i in range(k))))
    mol = a.molecules(0)[0]
    assert mol["num_nodes"] == a.sizes(0)[0]
    assert len(mol["edges"]) == len(mol["edge_features"])
    again = generator.Traffic(spec, 1).molecules(0)[0]
    assert all((mol[key] == again[key]).all() for key in
               ("edges", "node_features", "rdkit_coords"))


@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.SERVE])
def test_driver_control_flow_writes_no_device_metric(cell):
    rec = tiny.run(cell, seconds=0.5)
    result = rec["result"]
    assert result["device"]["platform"] == "cpu"
    assert result["metrics"] == {}
    assert list(result)[-1] == "checks"


def _run_cli(cwd):
    return subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload", tiny.TRAIN,
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails():
    out = _run_cli(ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in SPEC["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_a_metric_added_as_a_file_is_read(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "h100bench" / "metrics" / "probe_share.py").write_text(
        "def read(rec):\n    return 42.0\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "probe_share", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "kernels",
        "moves": "train_molecules_per_s", "workloads": [tiny.TRAIN]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(tmp_path, tmp_path / "h100bench")
    read = bench.read_metrics(tiny.TRAIN, {"mix": {"driver": "none"},
                                           "cfg": {}})
    assert read == {"probe_share": {"value": 42.0, "unit": "%"}}


def _on_device(name, start, end, stream=7, annotation=False):
    return SimpleNamespace(name=name, device_resource_id=stream,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_a_marked_call_is_credited_with_all_it_launched():
    call = "h100bench.call.Core.backward"
    events = [
        _on_device("gemm", 0.0, 100.0),
        _on_device(call, 120.0, 900.0, annotation=True),
        _on_device("copy", 120.0, 320.0),
        _on_device("tbwd::body", 330.0, 630.0),
        _on_device("other stream", 400.0, 500.0, stream=9),
        _on_device("copy", 650.0, 900.0),
        _on_device("h100bench.train_step", 0.0, 2000.0, annotation=True),
        _on_device("gemm", 950.0, 1000.0),
        _on_device(call, 1100.0, 1150.0, annotation=True),
        _on_device("tbwd::body", 1100.0, 1150.0),
    ]
    assert harness.call_seconds(events) == pytest.approx(
        {"Core.backward": 800e-6})


def test_marked_calls_wrap_the_entry_points_and_restore_them():
    from torch.profiler import ProfilerActivity, profile
    from tgt_torch.ops.kernels import triplet_dense as td
    entry = "tgt_torch.ops.kernels.triplet_dense:TripletDenseCore.backward"
    original = td.TripletDenseCore.__dict__["backward"]
    b, n, d, h = 1, 4, 2, 2
    q, k, v = (torch.randn(b, n, n, d, h, requires_grad=True)
               for _ in range(3))
    bias, gate = (torch.randn(b, n, n, h, requires_grad=True)
                  for _ in range(2))
    with harness.marked_calls([entry]), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        td.triplet_dense(q, k, v, bias, gate).sum().backward()
    assert td.TripletDenseCore.__dict__["backward"] is original
    names = [e.name for e in prof.events()]
    assert names.count("h100bench.call.TripletDenseCore.backward") == 1
    assert "h100bench.call.TripletDenseCore.forward" not in names
    assert all(t.grad is not None for t in (q, k, v, bias, gate))


def test_every_roofline_reader_names_entry_points_that_exist():
    bench = harness.Bench()
    for w in SPEC["workloads"]:
        for entry in bench.marked_calls(w["name"]):
            with harness.marked_calls([entry]):
                pass
