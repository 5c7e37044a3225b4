"""Training of AlphaFold 2's Evoformer: what the window drives is the port's
training loop, ``Trainer.train_epoch``, on crops that the port's scheme
collates on the loader's thread from the crops and alignments the traffic
makes (``h100bench/msa.py``); each crop is one batch and one Adam step
(``Trainer.train_step``), and counts as one item of
``train_molecules_per_s``.

Set-up imports the port's Evoformer first (a program without it fails
here, at once), then builds the port's scheme and the one trainer state
that the window goes on training: the benchmark's weights loaded into the
port's model, Adam's state from the port's optimizer. It drives that state
through the first crops of the traffic, reading after step 1 each leaf's
norm of the first gradient (from Adam's first moment) and after the last
check step each leaf's norm of the change. Every crop has the one shape the
window runs, so the check steps warm it. The reference
(``h100bench/reference/evoformer.py``) follows the check steps after the
window has closed and the program's state is freed.

Each step's span keeps the launch counters of the kernel wrappers, with
the dense triplet kernels' key-tiled route (``tiled_launches``), which the
triangle attention takes at 256 residues, and the counters of the port's
MSA ops (``msa.<name>``: the calls of each op and the SDPA backend each
attention took).
"""
from __future__ import annotations

import gc
import itertools
import time

import torch

from h100bench import harness, msa, program
from h100bench.drivers.train import ADAM_B1, LOADER_ITEMS
from h100bench.drivers.train_pairformer import Crops, _loader
from h100bench.drivers.train_pairformer import read_counters as kernel_counts
from h100bench.reference import evoformer as ref
from h100bench.yardstick import compare

REFERENCE_KEYS = ("target_feat", "residue_index", "msa_feat", "msa_mask",
                  "extra_msa_feat", "extra_msa_mask", "true_msa", "bert_mask",
                  "coords", "node_mask")


def read_counters():
    """The wrappers' launch counters and the MSA ops' counters."""
    from tgt_torch.ops import msa as msa_ops
    out = kernel_counts()
    out.update((f"msa.{k}", int(v)) for k, v in msa_ops.CALLS.items())
    return out


def counter_delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def build_model(model_cfg, weights, device):
    """The port's Evoformer, built without drawing weights of its own,
    holding ``weights``."""
    from tgt_torch.models.evoformer import EvoformerModel
    with torch.device("meta"):
        model = EvoformerModel(model_cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model


def run(ctx) -> dict:
    from tgt_torch.models.evoformer import EvoformerModel  # noqa: F401
    from tgt_torch.training.harness import Trainer

    cfg, mix, device, spans = ctx.cfg["config"], ctx.mix, ctx.device, ctx.spans
    crops = msa.MSACrops(mix, ctx.seed)
    shape = (mix["crop_tokens"], mix["msa_clusters"], mix["msa_extra"])
    with spans.span("setup.model"):
        scheme = program.scheme(cfg, "train", random_seed=ctx.seed)
        weights = ref.run_weights(cfg, ctx.seed, device)
        trainer = Trainer(scheme, device=device)
        model = build_model(scheme.model_cfg, weights, device)
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
        before = read_counters()
        with spans.span("train_step", step=step) as row:
            out = base_step(state_, batch, step, seed, lr_scale)
        row["tokens"] = int(batch["node_mask"].shape[1])
        row["counters"] = counter_delta(before, read_counters())
        steps.append({"metrics": out[1], "span": row})
        return out

    trainer.train_step = train_step
    dataset = Crops(crops, spans)

    def epoch(batches):
        with harness.quiet():
            return trainer.train_epoch(state, batches)

    # -- the check steps: the traffic's first crops, the window's call -------
    check = mix["check_steps"]
    readings = {}
    loader = _loader(dataset, scheme, spans, range(check))

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
        program.sync(device)
    del start
    prog = {"losses": [float(s["metrics"]["loss"]) for s in steps[:check]],
            "grad_norms": dict(zip(names, readings["grad"].tolist())),
            "change_norms": dict(zip(names, readings["change"].tolist()))}
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
            it = iter(_loader(dataset, scheme, spans, items))
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
    sizes = [crops.tokens(i) for i in window_items[:len(done)]]
    record = {"cfg": cfg, "mix": mix, "device": device.type,
              "window": {"seconds": window_s, "sizes": sizes,
                         "crops": [shape] * len(sizes),
                         "items": len(done)}}

    # -- the traced span, after the window ----------------------------------
    if ctx.trace:
        nxt = window_items[-1] + 1 if window_items else check
        items = list(range(nxt, nxt + mix["trace_items"]))
        first_traced = len(steps)
        with harness.marked_calls(ctx.marks), \
                harness.profiled(True, device) as holder:
            epoch(iter(_loader(dataset, scheme, spans, items)))
        if holder["prof"] is not None:
            record["trace"] = harness.reduce_trace(holder["prof"])
            if record["trace"] is not None:
                record["trace"]["items"] = [
                    {"tokens": s["span"]["tokens"], "rows": 1,
                     "sizes": [crops.tokens(i)], "sequences": shape[1],
                     "extra": shape[2], "counters": s["span"]["counters"]}
                    for s, i in zip(steps[first_traced:], items)]

    record["device_info"] = harness.device_record(device, ctx.chips)
    record["forbidden"] = harness.forbidden_modules()
    attempted = len(done)
    del state, model, params, trainer, scheme, steps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference follows the check steps -------------------------------
    ref_out = reference_readings(ctx, crops, cast=ctx.reference_cast)
    record["details"] = compare.training_details(prog, ref_out)
    record.update(e2e={"train_molecules_per_s": len(sizes) / window_s,
                       "setup_s": setup_s},
                  attempted=attempted, failed=failed,
                  numbers=compare.training(prog, ref_out))
    return record


def reference_batch(crop: dict, device) -> dict:
    return {k: torch.from_numpy(crop[k][None]).to(device)
            for k in REFERENCE_KEYS}


def reference_readings(ctx, crops, cast=None) -> dict:
    """The reference's losses and leaf norms over the check steps, from the
    same weights and crops."""
    cfg, device = ctx.cfg["config"], ctx.device
    weights = ref.run_weights(cfg, ctx.seed, device)
    batches = [reference_batch(crops.crop(k), device)
               for k in range(ctx.mix["check_steps"])]
    with ref.no_tf32():
        return ref.train_steps(weights, cfg, batches, ctx.seed,
                               cast=cast or ref.identity)
