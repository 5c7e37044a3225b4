"""Training: what the window drives is the port's training loop,
``Trainer.train_epoch``, on batches that the port's data layer builds (its
structural transform in a dataset, its collate on the loader's thread) from
the molecules the traffic generator makes; each batch is one micro-batch
and one Adam step (``Trainer.train_step``).

Set-up builds the one trainer state that the window goes on training: the
benchmark's weights loaded into the port's model, Adam's state from the
port's optimizer. It drives that state through the first steps of the
traffic, reading after step 1 each leaf's norm of the first gradient (from
Adam's first moment) and after the last check step each leaf's norm of the
change, then one step on a pool batch of every bucket the traffic uses
that the check steps missed. The reference follows the check steps after
the window has closed and the program's state is freed.
"""
from __future__ import annotations

import gc
import itertools
import time

import numpy as np
import torch

from h100bench import generator, harness, program
from h100bench.reference import data as ref_data
from h100bench.reference import model as ref_model
from h100bench.reference import train as ref_train
from h100bench.yardstick import compare

ADAM_B1 = 0.9
LOADER_ITEMS = 256     # items of each DataLoader the window goes through


class Molecules:
    """Map-style dataset of the traffic's molecules, flat index item * k +
    position, each through the port's structural transform."""

    def __init__(self, traffic: generator.Traffic, spans: harness.Spans):
        from tgt_torch.data.structural import AddStructuralData
        self.traffic = traffic
        self.k = traffic.mix["item_molecules"]
        self.transform = AddStructuralData()
        self.spans = spans
        self.warm = {}          # flat index -> molecule, for warm-up items

    def __getitem__(self, idx):
        if idx < 0:
            mol = self.warm[idx]
        else:
            item, pos = divmod(idx, self.k)
            mol = self.traffic.molecule(item, pos)
        with self.spans.span("structural_transform"):
            row = self.transform(mol)
        row["node_mask"] = np.ones(row["num_nodes"], np.uint8)
        return row


def _loader(dataset, scheme, spans, index_lists):
    from tgt_torch.data.loader import DataLoader
    return DataLoader(dataset, index_lists,
                      collate_fn=spans.wrap("collate", scheme._collate))


def _item_indices(k, item):
    return list(range(item * k, (item + 1) * k))


def run(ctx) -> dict:
    from tgt_torch.training.harness import Trainer

    cfg, mix, device, spans = ctx.cfg["config"], ctx.mix, ctx.device, ctx.spans
    traffic = generator.Traffic(mix, ctx.seed)
    k = mix["item_molecules"]
    buckets = list(cfg["buckets"])
    with spans.span("setup.model"):
        weights = ref_model.run_weights(cfg, ctx.seed, device)
        scheme = program.scheme(cfg, "train", random_seed=ctx.seed)
        trainer = Trainer(scheme, device=device)
        model = program.distance_model(scheme.model_cfg, weights, device)
        del weights
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    with torch.no_grad():
        state = {"model": model, "opt_state": trainer.opt_init(
            {n: p.detach() for n, p in zip(names, params)})}
        start = [p.detach().clone() for p in params]

    steps = []                       # one entry per train_step call
    base_step = trainer.train_step

    def train_step(state_, batch, step, seed, lr_scale=1.0):
        before = harness.read_counters()
        with spans.span("train_step", step=step) as row:
            out = base_step(state_, batch, step, seed, lr_scale)
        row["bucket"] = int(batch["node_features"].shape[1])
        row["rows"] = int(batch["node_features"].shape[0])
        row["counters"] = harness.counter_delta(before,
                                                harness.read_counters())
        steps.append({"metrics": out[1], "span": row})
        return out

    trainer.train_step = train_step
    dataset = Molecules(traffic, spans)

    def epoch(batches):
        with harness.quiet():
            return trainer.train_epoch(state, batches)

    # -- the check steps: the traffic's first items, the window's call ----
    check = mix["check_steps"]
    readings = {}
    loader = _loader(dataset, scheme, spans,
                     [_item_indices(k, i) for i in range(check)])

    def check_batches():
        it = iter(loader)
        try:
            for i, batch in enumerate(it):
                yield batch
                if i == 0:
                    mu = [state["opt_state"]["mu"][n] for n in names]
                    readings["grad"] = torch.stack(
                        torch._foreach_norm(mu)) / (1.0 - ADAM_B1)
        finally:
            it.close()
        readings["change"] = torch.stack(torch._foreach_norm(
            torch._foreach_sub([p.detach() for p in params], start)))

    with spans.span("setup.check_steps"):
        epoch(check_batches())
    del start
    losses = [float(s["metrics"]["loss"]) for s in steps[:check]]
    prog = {"losses": losses,
            "grad_norms": dict(zip(names, readings["grad"].tolist())),
            "change_norms": dict(zip(names, readings["change"].tolist()))}
    seen = {generator.bucket_of(traffic.sizes(i), buckets)
            for i in range(check)}

    # -- one step at every other bucket the traffic uses --------------------
    with spans.span("setup.warmup"):
        for p_item, sizes in enumerate(traffic.pool):
            b = generator.bucket_of(sizes, buckets)
            if b in seen:
                continue
            seen.add(b)
            idx = [-(p_item * k + j + 1) for j in range(k)]
            dataset.warm.update(zip(idx, traffic.warm(p_item)))
            epoch(iter(_loader(dataset, scheme, spans, [idx])))
        program.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t_start

    # -- the window ----------------------------------------------------------
    first = len(steps)
    window_items = []
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds

    def window_batches():
        for e in itertools.count():
            items = range(check + e * LOADER_ITEMS,
                          check + (e + 1) * LOADER_ITEMS)
            it = iter(_loader(dataset, scheme, spans,
                              [_item_indices(k, i) for i in items]))
            try:
                for item, batch in zip(items, it):
                    if time.perf_counter() >= deadline:
                        return
                    window_items.append(item)
                    yield batch
            finally:
                it.close()

    epoch(window_batches())
    program.sync(device)
    window_s = time.perf_counter() - t0
    done = steps[first:]
    failed = sum(1 for s in done if not bool(s["metrics"]["ok"]))
    sizes = [n for i in window_items[:len(done)] for n in traffic.sizes(i)]

    record = {"cfg": cfg, "mix": mix, "device": device.type,
              "window": {"seconds": window_s, "sizes": sizes,
                         "items": len(done)}}

    # -- the traced span, after the window ----------------------------------
    if ctx.trace:
        nxt = window_items[-1] + 1 if window_items else check
        items = list(range(nxt, nxt + mix["trace_items"]))
        first_traced = len(steps)
        with harness.marked_calls(ctx.marks), \
                harness.profiled(True, device) as holder:
            epoch(iter(_loader(dataset, scheme, spans,
                               [_item_indices(k, i) for i in items])))
        if holder["prof"] is not None:
            record["trace"] = harness.reduce_trace(holder["prof"])
            if record["trace"] is not None:
                record["trace"]["items"] = [
                    {"bucket": s["span"]["bucket"], "rows": s["span"]["rows"],
                     "sizes": traffic.sizes(i),
                     "counters": s["span"]["counters"]}
                    for s, i in zip(steps[first_traced:], items)]

    record["device_info"] = harness.device_record(device, ctx.chips)
    record["forbidden"] = harness.forbidden_modules()
    attempted = len(done)
    del state, model, params, trainer, scheme, steps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference follows the check steps -------------------------------
    ref = reference_readings(ctx, traffic, cast=ctx.reference_cast)
    numbers = compare.training(prog, ref)
    record["details"] = compare.training_details(prog, ref)
    record.update(e2e={"train_molecules_per_s": len(sizes) / window_s,
                       "setup_s": setup_s},
                  attempted=attempted, failed=failed, numbers=numbers)
    return record


def reference_readings(ctx, traffic, cast=None) -> dict:
    """The reference's losses and leaf norms over the check steps, from the
    same weights and molecules."""
    cfg, mix, device = ctx.cfg["config"], ctx.mix, ctx.device
    weights = ref_model.run_weights(cfg, ctx.seed, device)
    batches = [ref_data.collate(traffic.molecules(i), cfg["buckets"],
                                mix["item_molecules"], device,
                                ("rdkit_coords", "dft_coords"))
               for i in range(mix["check_steps"])]
    with ref_model.no_tf32():
        return ref_train.train_steps(weights, cfg, batches, ctx.seed,
                                     cast=cast or ref_model.identity)

