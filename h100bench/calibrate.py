"""The readings that the limits of ``correct`` are set from, for one cell
on the card (not run by the benchmark's own runs):

    python3 -m h100bench.calibrate --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3 [--seconds 10]

For every seed, a run of the cell as the benchmark runs it (a short window
at the cell's own load) gives the program's numbers against the reference.
For each control seed, the control gives its numbers: the reference
computed with float8 (e4m3, per-tensor scaled) matrix products, the
nearest precision below the configuration's bf16, put in the program's
place against the float32 reference on the same inputs. For a training
cell, each control seed also reads the program with half of every batch
left out of the loss (the mean taken over the rest). One JSON line per
reading.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def half_batch_fault():
    """Plant the fault in the port's loss: every batch's second half left
    out, the mean taken over the first. Returns the undo."""
    from tgt_torch.schemes.dist_pred import DistPredScheme
    original = DistPredScheme.loss_fn

    def loss_fn(self, model, batch, seed):
        b = batch["node_features"].shape[0]
        half = {k: v[:b // 2] if v.dim() >= 1 and v.shape[0] == b else v
                for k, v in batch.items()}
        return original(self, model, half, seed)

    DistPredScheme.loss_fn = loss_fn
    return lambda: setattr(DistPredScheme, "loss_fn", original)


def control_numbers(bench, cell, seed, record, device):
    from h100bench import generator, harness
    from h100bench.reference import model as ref_model
    from h100bench.yardstick import compare
    c = bench.cell(cell)
    cfg, mix = bench.config(c["config"]), bench.mix(c["traffic"])
    ctx = SimpleNamespace(cfg=cfg, mix=mix, seed=seed % 2 ** 63,
                          device=device, spans=harness.Spans())
    traffic = generator.Traffic(mix, ctx.seed)
    driver = bench.driver(mix["driver"])
    if mix["driver"] == "train":
        ref = driver.reference_readings(ctx, traffic)
        ctl = driver.reference_readings(ctx, traffic, cast=ref_model.fp8_cast)
        return compare.training(ctl, ref), compare.training_details(ctl, ref)
    judged = record["judged"]
    ref = driver.reference_outputs(ctx, traffic, judged["pred_seed"],
                                   judged["calls"])
    ctl = driver.reference_outputs(ctx, traffic, judged["pred_seed"],
                                   judged["calls"], cast=ref_model.fp8_cast)
    sizes = {i: traffic.sizes(i)[0] for i in ref}
    numbers = compare.serving(ctl, ref, sizes)
    ref0, ctl0 = (driver.reference_outputs(
        ctx, traffic, judged["pred_seed"], judged["calls"], cast=cast,
        dropout=False) for cast in (None, ref_model.fp8_cast))
    numbers["prob_gap_rate0"] = compare.serving(ctl0, ref0, sizes)["prob_gap"]
    return numbers, compare.serving_details(ctl, ref, sizes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch
    from h100bench import harness
    from h100bench.run import execute
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    harness.set_cache_dirs()
    device = torch.device("cuda")
    bench = harness.Bench()
    mix = bench.mix(bench.cell(args.workload)["traffic"])
    print(json.dumps({"card": harness.card_line()}), flush=True)
    for seed in args.seeds:
        run = SimpleNamespace(workload=args.workload, seed=seed,
                              seconds=args.seconds, trace=0)
        rec = execute(bench, run, device, time.perf_counter())
        print(json.dumps({"reading": "program", "seed": seed,
                          "numbers": rec["numbers"],
                          "details": rec.get("details"), "e2e": rec["e2e"],
                          "attempted": rec["attempted"],
                          "failed": rec["failed"]}), flush=True)
        if seed not in args.control_seeds:
            continue
        numbers, details = control_numbers(bench, args.workload, seed, rec,
                                           device)
        print(json.dumps({"reading": "control_fp8", "seed": seed,
                          "numbers": numbers, "details": details}),
              flush=True)
        if mix["driver"] == "train":
            undo = half_batch_fault()
            try:
                bad = execute(bench, run, device, time.perf_counter())
            finally:
                undo()
            print(json.dumps({"reading": "fault_half_batch", "seed": seed,
                              "numbers": bad["numbers"],
                              "details": bad.get("details")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
