"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's configuration, traffic mix, driver and limits are found by name
from ``BENCHMARK.json``. With ``--trace 0`` the metrics are the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from a
profiled span that follows the window. The numbers that decide
``correct`` are printed beside their limits, as the last lines of standard
error and under ``checks``, the last key of the result. Without a CUDA
device, or with fewer than the cell asks for, the run exits with 2 and
prints no result: it never falls back to the CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(bench, args, device, t_start, reference_cast=None) -> dict:
    """One run of a cell on ``device``: the driver's record, with the
    result the harness prints (``result``) and the lines that give each
    compared number beside its limit (``check_lines``)."""
    from h100bench import harness
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    limits = bench.limits(cell["name"])
    spans = harness.Spans()
    spans.rows.append({"name": "setup.start", "t0": t_start, "t1": t_start})
    ctx = SimpleNamespace(cfg=cfg, mix=mix, seed=args.seed % 2 ** 63,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=device, chips=cell["chips"], spans=spans,
                          t_start=t_start, reference_cast=reference_cast,
                          marks=(bench.marked_calls(cell["name"])
                                 if args.trace else []))
    record = bench.driver(mix["driver"]).run(ctx)
    from h100bench.yardstick import compare
    numbers = record["numbers"]
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": limits.get(k, {}).get("limit")}
              for k, v in numbers.items()}
    correct = (compare.judge(numbers, limits) and record["failed"] == 0
               and not record["forbidden"])
    if device.type != "cuda":        # a CPU run writes no device metric
        metrics = {}
    elif args.trace:
        metrics = bench.read_metrics(cell["name"], record)
    else:
        units = {m["name"]: m["unit"] for m in bench.end_to_end(cell["name"])}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in record["e2e"].items() if k in units}
    device_info = dict(record["device_info"])
    trace = record.get("trace")
    if args.trace and trace is not None:
        device_info["busy_s"] = trace["busy_s"]
        device_info["window_s"] = trace["span_s"]
    result = {"correct": bool(correct), "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": device_info}
    if args.trace and trace is not None:
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = checks
    record["result"] = result
    record["check_lines"] = [
        f"{k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    spans.write(harness.OUT_DIR / f"{args.workload}.seed{args.seed}"
                                  f".trace{args.trace}.spans.json")
    return record


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from h100bench import harness

    if not torch.cuda.is_available():
        print("h100bench: no CUDA device; a run never falls back to the CPU",
              file=sys.stderr)
        return 2
    bench = harness.Bench()
    cell = bench.cell(args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        print(f"h100bench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    harness.set_cache_dirs()
    print(f"h100bench: {harness.card_line()}", file=sys.stderr, flush=True)
    record = execute(bench, args, torch.device("cuda"), T_START)
    found = harness.forbidden_modules()
    if found or record["forbidden"]:
        print(f"h100bench: JAX or the JAX package is loaded: "
              f"{sorted(set(found) | set(record['forbidden']))}",
              file=sys.stderr)
        return 3
    for line in record["check_lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(record["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
