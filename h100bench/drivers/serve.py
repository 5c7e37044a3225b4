"""Serving: what the window drives is the port's ``DistancePredictor.predict``
under a closed loop of one client: each request is sent when the previous
one has returned, with its result on the host.

Set-up builds the predictor around the port's model holding the
benchmark's weights and serves one dummy molecule per bucket through it
(``warmup``). After the window, a sample of the finished requests drawn
from the seed, the one with the most atoms among them, is judged against
the reference, which recomputes each from the raw molecule, the weights
and the MC-draw seeds that the predictor's seed gives that call, drawing
every dropout mask in the program's layout (each draw's generator fills
the whole padded device batch of ``batch_size`` rows, and the reference
keeps the molecule's row). The same requests are served once more with
every dropout off, through the same ``predict``, and judged against the
reference at rate 0, where no draw layout enters: a program whose served
answers fail only the first comparison has changed how it draws its
masks, not what it computes.
"""
from __future__ import annotations

import functools
import gc
import time

import numpy as np
import torch

from h100bench import generator, harness, program
from h100bench.reference import data as ref_data
from h100bench.reference import model as ref_model
from h100bench.yardstick import compare

PREDICTOR = 12        # the predictor's seed of its MC draws
SAMPLE = 13           # the sample of requests the reference judges


def run(ctx) -> dict:
    from tgt_torch.serving import DistancePredictor

    cfg, mix, device, spans = ctx.cfg["config"], ctx.mix, ctx.device, ctx.spans
    traffic = generator.Traffic(mix, ctx.seed)
    with spans.span("setup.model"):
        weights = ref_model.run_weights(cfg, ctx.seed, device)
        scheme = program.scheme(cfg, "evaluate")
        model = program.distance_model(scheme.model_cfg, weights, device)
        del weights
    pred_seed = ref_model.derive_seed(ctx.seed, PREDICTOR)
    pred = DistancePredictor(model, scheme.model_cfg,
                             mc_samples=cfg["evaluation_samples"],
                             batch_size=mix["batch_size"],
                             buckets=cfg["buckets"], seed=pred_seed,
                             device=device, mc_mode=mix["mc_mode"])
    calls = []                       # one entry per predict call
    base_predict = pred.predict

    def predict(molecules):
        before = harness.read_counters()
        with spans.span("predict", call=len(calls)) as row:
            out = base_predict(molecules)
        row["counters"] = harness.counter_delta(before,
                                                harness.read_counters())
        row["bucket"] = int(out.shape[1])
        calls.append(row)
        return out

    pred.predict = predict
    with spans.span("setup.warmup"):
        pred.warmup()
        program.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start

    # -- the window: a closed loop of one client ------------------------------
    served = []                      # (item, call, latency s, output or None)
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    k = 0
    while time.perf_counter() < deadline:
        mols = traffic.molecules(k)
        call = len(calls)
        sent = time.perf_counter()
        try:
            out = predict(mols)
        except Exception as exc:     # a failed request counts, and is slow
            print(f"request {k} failed: {exc!r}", flush=True)
            out = None
        latency = time.perf_counter() - sent
        if out is not None:          # the molecule's own atoms, kept apart
            n = traffic.sizes(k)[0]
            out = out[0, :n, :n].copy()
        served.append((k, call, latency, out))
        k += 1
    window_s = time.perf_counter() - t0
    good = [s[3] is not None and bool(np.isfinite(s[3]).all())
            for s in served]
    ok = [s for s, g in zip(served, good) if g]
    failed = len(served) - len(ok)
    # a failed request counts as slower than every other request
    worst = max((s[2] for s in ok), default=0.0) + window_s
    latencies = [s[2] if g else worst for s, g in zip(served, good)]
    sizes = [n for s in ok for n in traffic.sizes(s[0])]
    record = {"cfg": cfg, "mix": mix, "device": device.type,
              "window": {"seconds": window_s, "sizes": sizes,
                         "items": len(ok)}}

    # -- the traced span, after the window ----------------------------------
    if ctx.trace:
        items = list(range(k, k + mix["trace_items"]))
        first = len(calls)
        with harness.marked_calls(ctx.marks), \
                harness.profiled(True, device) as holder:
            for i in items:
                predict(traffic.molecules(i))
        if holder["prof"] is not None:
            record["trace"] = harness.reduce_trace(holder["prof"])
            if record["trace"] is not None:
                rows = mix["batch_size"] * cfg["evaluation_samples"]
                record["trace"]["items"] = [
                    {"bucket": c["bucket"], "rows": rows,
                     "sizes": traffic.sizes(i), "counters": c["counters"]}
                    for c, i in zip(calls[first:], items)]

    record["device_info"] = harness.device_record(device, ctx.chips)
    record["forbidden"] = harness.forbidden_modules()
    sample = sample_requests(ok, mix["check_requests"], ctx.seed)
    outputs = {s[0]: (s[1], s[3]) for s in sample}
    rate0 = served_without_dropout(pred, base_predict, model, traffic,
                                   sorted(outputs))
    del pred, model, scheme, served, ok, sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    judged = {i: c for i, (c, _) in outputs.items()}
    ref = reference_outputs(ctx, traffic, pred_seed, judged,
                            cast=ctx.reference_cast)
    served = {i: o for i, (_, o) in outputs.items()}
    sizes_judged = {i: traffic.sizes(i)[0] for i in outputs}
    numbers = compare.serving(served, ref, sizes_judged)
    ref0 = reference_outputs(ctx, traffic, pred_seed, judged,
                             cast=ctx.reference_cast, dropout=False)
    numbers["prob_gap_rate0"] = compare.serving(rate0, ref0,
                                                sizes_judged)["prob_gap"]
    record["details"] = compare.serving_details(served, ref, sizes_judged)
    record.update(e2e={"serve_molecules_per_s": len(sizes) / window_s,
                       "serve_p95_s": float(np.percentile(latencies, 95)),
                       "setup_s": setup_s},
                  attempted=len(latencies), failed=failed, numbers=numbers,
                  judged={"pred_seed": pred_seed, "calls": judged})
    return record


def sample_requests(ok, count: int, seed: int):
    """``count`` finished requests drawn from the seed, the one with the
    most atoms among them."""
    if not ok:
        return []
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), SAMPLE]))
    pick = set(rng.choice(len(ok), size=min(count, len(ok)),
                          replace=False).tolist())
    longest = max(range(len(ok)), key=lambda t: int(ok[t][3].shape[0]))
    pick.discard(longest)
    pick = sorted(pick)[:count - 1] + [longest]
    return [ok[t] for t in pick]


def _no_dropout(model, feed, deterministic=False, seed=None):
    return model(feed, deterministic=True, seed=seed)


def served_without_dropout(pred, predict, model, traffic, items):
    """Item -> the molecule's own atoms of what ``predict`` returns for it
    with every dropout of the model off: the served path's collation,
    padding, draw stacking and kernels, with no mask in it."""
    saved = pred.model
    pred.model = functools.partial(_no_dropout, model)
    try:
        out = {}
        for item in items:
            n = traffic.sizes(item)[0]
            out[item] = predict(traffic.molecules(item))[0, :n, :n].copy()
    finally:
        pred.model = saved
    return out


def mc_seeds(pred_seed: int, call: int, draws: int):
    """The MC-draw seeds of predict call ``call`` (one device batch per
    call): the predictor's host generator, drawn once per device batch."""
    gen = torch.Generator().manual_seed(int(pred_seed))
    for _ in range(call + 1):
        seeds = torch.randint(0, 2 ** 62, (draws,), generator=gen).tolist()
    return seeds


def reference_outputs(ctx, traffic, pred_seed, calls, cast=None,
                      dropout=True):
    """Item -> the reference's MC mean of the symmetrised bin
    probabilities (n, n, bins) over the molecule's own atoms; with
    ``dropout`` off, the one forward at rate 0."""
    cfg, mix, device = ctx.cfg["config"], ctx.mix, ctx.device
    draws = cfg["evaluation_samples"] if dropout else 1
    weights = ref_model.run_weights(cfg, ctx.seed, device)
    out = {}
    with torch.no_grad(), ref_model.no_tf32():
        for item, call in calls.items():
            mol = traffic.molecules(item)[0]
            batch = ref_data.collate([mol] * draws, cfg["buckets"], draws,
                                     device)
            batch["dist_input"] = ref_data.coords2dist(batch["rdkit_coords"])
            logits = ref_model.forward(
                weights, cfg, batch,
                seeds=mc_seeds(pred_seed, call, draws) if dropout else None,
                draw_of=list(range(draws)), rows=[0] * draws,
                program_batch=mix["batch_size"],
                cast=cast or ref_model.identity)
            p = torch.softmax(logits, dim=-1)
            p = (p + p.transpose(1, 2)).mean(dim=0) / 2.0
            n = int(mol["num_nodes"])
            out[item] = p[:n, :n].cpu().numpy()
    return out
