"""Where the time of a distance model goes, on one CUDA card.

    python -m tgt_torch.profiling [--path serve] [--n 48] [--batch 16]
                                  [--steps 3] [--config YAML]
                                  [--use-pallas dense|true|false]
    python -m tgt_torch.profiling --path train [--steps 2] [--config YAML]

Builds the distance model of ``--config`` (by default the flagship TGT-At,
configs/pcqm/tgt_at_200m/dist_pred/tgt_at_dp_rdkit.yaml; for TGT-Agx2 pass
configs/pcqm/tgt_agx2_100m/dist_pred/tgt_agx2_dp_rdkit.yaml with
``--use-pallas dense``, which that config leaves unset; ``--use-pallas true``
profiles the legacy fused triplet kernels) with weights from a seed and
traces, with ``torch.profiler`` after a warm-up:
- ``serve``: ``--steps`` calls of ``DistancePredictor.predict`` on one
  device batch of ``--batch`` random molecules at bucket ``--n``, each one
  MC-dropout forward of ``--batch`` rows; the Chrome trace is written as
  ``profile_serving_<config>_n<N>.json`` into the repository's git-ignored
  output directory;
- ``train``: ``--steps`` optimizer steps of ``Trainer.train_step`` on one
  batch of 64 synthetic molecules of up to 48 atoms (2 accumulated
  micro-batches of 32, bf16, remat), as ``chip_smoke.py`` phase 4 trains.
  No trace is written: a step launches tens of thousands of kernels.

Prints JSON lines: the wall time per call or step, the device busy share
of the window (the union of the device operations' intervals over the wall
time, so the rest is the device idle while the host enqueues), the kernels
that take the most device time, the launches per call or step, the device
time of each of the package's own CUDA kernels, and the host time of each
of the port's spans (``tgt_torch.utils.tracing``) per call or step, total
and self (less the spans directly under it).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from tgt_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name fragments of the package's own CUDA kernels (tgt_torch/csrc), listed
# apart from the top kernels whatever their rank
OWN_KERNELS = ("triplet", "agg_", "tagb::", "tfwd::", "tbwd::")
FLAGSHIP_YAML = os.path.join(
    REPO, "configs", "pcqm", "tgt_at_200m", "dist_pred", "tgt_at_dp_rdkit.yaml")


def _molecules(rs, n_bucket: int, b: int) -> List[Dict]:
    """``b`` random chain molecules of ``n_bucket - 7`` to ``n_bucket``
    atoms with coordinates, as a request gives them."""
    mols = []
    for n in rs.randint(n_bucket - 7, n_bucket + 1, size=b):
        n = int(n)
        edges = np.array([(i, i + 1) for i in range(n - 1)]
                         + [(i + 1, i) for i in range(n - 1)], np.int64)
        mols.append({
            "num_nodes": n, "edges": edges,
            "node_features": rs.randint(0, 60, (n, 9)).astype(np.int16),
            "edge_features": rs.randint(0, 5, (len(edges), 3)).astype(np.int16),
            "coords": (rs.randn(n, 3) * 1.5).astype(np.float32)})
    return mols


def device_busy_s(events) -> float:
    """Seconds in which an operation ran on the device: the union of the
    device operations' intervals (``prof.events()``), less the profiler
    ranges that the device timeline also shows, which are not work."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cuda and not _annotation(e))
    busy_us, cursor = 0.0, float("-inf")
    for start, end in spans:
        if end > cursor:
            busy_us += end - max(start, cursor)
            cursor = end
    return busy_us / 1e6


def _annotation(e) -> bool:
    """Whether a profiler event (or average) is a range of
    ``record_function`` rather than an operation."""
    name = getattr(e, "key", None) or e.name
    return bool(getattr(e, "is_user_annotation", False)) or \
        name.startswith(tracing.PREFIX)


def span_table(rows: List[Dict], per: int) -> List[Dict]:
    """Each span name's calls and host ms, total and self (less the spans
    directly under it), per call or step of ``per``, most total first."""
    child_ms: Dict[int, float] = {}
    for r in rows:
        if r["parent"] is not None:
            child_ms[r["parent"]] = (child_ms.get(r["parent"], 0.0)
                                     + (r["t1"] - r["t0"]) / 1e6)
    table: Dict[str, Dict] = {}
    for r in rows:
        ms = (r["t1"] - r["t0"]) / 1e6
        t = table.setdefault(r["name"], {"span": r["name"], "calls": 0,
                                         "host_ms": 0.0, "self_ms": 0.0})
        t["calls"] += 1
        t["host_ms"] += ms
        t["self_ms"] += ms - child_ms.get(r["id"], 0.0)
    out = [{"span": t["span"], "calls_per_step": t["calls"] / per,
            "host_ms_per_step": t["host_ms"] / per,
            "self_ms_per_step": t["self_ms"] / per} for t in table.values()]
    return sorted(out, key=lambda t: t["host_ms_per_step"], reverse=True)


def parse_use_pallas(value: str):
    """``--use-pallas``: "true" and "false" are the booleans a yaml would
    give (True selects the legacy fused kernels), anything else a string."""
    return {"true": True, "false": False}.get(value.lower(), value)


def _raw_config(args, **extra):
    from tgt_torch.core.config import load_yaml

    raw = load_yaml(args.config)
    if args.use_pallas is not None:
        raw["use_pallas"] = args.use_pallas
    raw.update(extra)
    return raw


def _serving(args):
    """(run(i), description) of one served call."""
    from tgt_torch.models import make_model
    from tgt_torch.schemes import get_scheme
    from tgt_torch.serving import DistancePredictor

    raw = _raw_config(args)
    cfg = get_scheme(raw["scheme"])(raw, command="evaluate").model_cfg
    model = make_model("distance", cfg, device="cuda", seed=0)
    pred = DistancePredictor(model, cfg, mc_samples=1,
                             batch_size=args.batch, buckets=(args.n,),
                             device="cuda")
    mols = _molecules(np.random.RandomState(0), args.n, args.batch)

    def run(i):
        pred.predict(mols)

    return run, {"profile": "served call (DistancePredictor.predict, one "
                            "MC-dropout forward)", "n": args.n,
                 "batch": args.batch, "use_pallas": cfg.use_pallas}


def _training(args):
    """(run(i), description) of one optimizer step of the trainer."""
    from tgt_torch.schemes import get_scheme
    from tgt_torch.training import Trainer

    raw = _raw_config(args, dataset_source="synthetic", synth_max_nodes=48,
                      synth_train_samples=64, global_batch_size=64)
    scheme = get_scheme(raw["scheme"])(raw, command="train")
    trainer = Trainer(scheme, device="cuda")
    state = trainer.init_state(seed=0)
    host = next(iter(scheme.train_loader(0, 0, 1)))
    batch = trainer.to_device(trainer.pad_device_batch(
        scheme.device_batch(host)))

    def run(i):
        trainer.train_step(state, batch, i, seed=i)

    return run, {"profile": "training step (Trainer.train_step)",
                 "n": int(batch["node_features"].shape[1]),
                 "batch": int(batch["node_features"].shape[0]),
                 "accum": trainer.grad_accum,
                 "use_pallas": scheme.model_cfg.use_pallas}


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("serve", "train"), default="serve")
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--config", default=FLAGSHIP_YAML,
                    help="a dist_pred config (default: the flagship TGT-At)")
    ap.add_argument("--use-pallas", default=None, type=parse_use_pallas,
                    help="override the config's use_pallas: dense, true "
                         "(the legacy fused kernels) or false")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    run, desc = (_serving if args.path == "serve" else _training)(args)
    for i in range(2):
        run(i)
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            run(100 + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events
               if e.device_type == cuda and not _annotation(e)]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    print(json.dumps({**desc, "config": os.path.relpath(args.config, REPO),
                      "card": card, "steps": args.steps,
                      "wall_ms_per_step": wall * 1e3 / args.steps,
                      "device_ms_per_step": device_us / 1e3 / args.steps,
                      "device_busy_share":
                          device_busy_s(prof.events()) / wall,
                      "kernel_launches_per_step":
                          sum(e.count for e in kernels) / args.steps}),
          flush=True)
    for e in top[:15]:
        if e.self_device_time_total <= 0:
            break
        print(json.dumps({"kernel": e.key[:90], "calls": e.count,
                          "device_ms_per_step":
                              e.self_device_time_total / 1e3 / args.steps,
                          "share": e.self_device_time_total / device_us}),
              flush=True)
    own = {}
    for e in kernels:
        if any(t in e.key for t in OWN_KERNELS):
            own[e.key[:90]] = {"calls": e.count, "device_ms_per_step":
                               e.self_device_time_total / 1e3 / args.steps}
    print(json.dumps({"package_kernels": own}), flush=True)
    for row in span_table(tracing.recorded(), args.steps):
        print(json.dumps(row), flush=True)
    if args.path == "serve":
        out_dir = os.path.join(REPO, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        name = os.path.splitext(os.path.basename(args.config))[0]
        prof.export_chrome_trace(os.path.join(
            out_dir, f"profile_serving_{name}_n{args.n}.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
