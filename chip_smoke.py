#!/usr/bin/env python3
"""Smoke run of tgt_torch on one NVIDIA card (built for the H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:

1. Environment and build: versions, the card's name and power limit, and
   the build of the six CUDA kernel sources of the package from this
   checkout (``nvcc`` for sm_90a, one process per source, started
   together), with each kernel's ptxas report (registers and spill bytes
   per function); a spill in any tensor-core body (the attention backward
   ``triplet_bwd_mma.cuh``, the attention forward ``triplet_fwd_mma.cuh``,
   the aggregate bodies in ``triplet_aggregate_bwd.cu`` and
   ``triplet_aggregate_fwd.cu``) fails the run.
2. Kernel against plain: ``triplet_dense_fwd`` against its plain PyTorch
   version on the card at b=16, N in {24, 40, 48, 56}, edge width 256,
   16 triplet heads; gated and ungated; bf16 and f32; plus the training
   micro-batch, b=32, N=48, bf16, gated and ungated; the published eval
   batches, b=64 (stage 1's batch_size 32 x prediction_bmult 2, and stage
   2's training micro-batch), N=48 and 56, and b=128 (stage 2's 64 x 2),
   N=48, bf16, gated, each with its back-to-back device time and its
   plain version's; plus the F3 shapes that
   no published bucket reaches (N=80 and N=128 at b=4; edge widths 128 and
   512, d = 8 and 32, at b=16, N=48; gated, bf16 and f32); and the out
   direction's pair-transposed K/V views at b=32 in bf16 and f32; with a
   padded sample, a fully masked sample (zero when gated) and a head whose
   bias sits 300 below the rest. Tolerance max|diff| <= 1e-4 max|ref| in
   f32, 1e-2 max|ref| in bf16 (bf16 output rounding is 2^-8). Two launches
   on the same inputs bitwise equal (bf16 at N=48 and the F3 shapes). One
   JSON line per case with the kernel's and the plain version's times (CUDA
   events, median of 20) and the bound; for the ungated cases also the
   library time: one call of ``scaled_dot_product_attention`` with the bias
   as an additive mask on head-major copies, and the backend that ran. At
   N=48 in bf16 both layout routes of the bf16 forward are timed in turns,
   the in-place loader and the head-major copies, and the copies alone.
2b. The backward kernel against plain: ``triplet_dense_bwd`` against
   ``triplet_dense_bwd_reference`` on the same cases with a random
   cotangent; dq, dk, dv, dbias and dgate each within the tolerances above;
   the out direction's pair-transposed K/V views at b=32, N=48 in bf16 and
   f32; two launches on the same inputs bitwise equal (bf16 at N=48 and the
   F3 shapes); the library time is SDPA's backward; at N=48 in bf16 also
   the time of the wrapper's head-major copies alone. Also stage 2's
   training micro-batch, b=64, N=48 and 56 (bucket 56 through the
   head-major copies), bf16, gated, bitwise equal on repeat, with the
   back-to-back device times of the kernel and its plain version.
2c. The dense pair at dropout rate 0.3 against its plain versions with the
   same per-row seeds, on phase 2b's cases and the transposed K/V views at
   b=32: the forward and the five gradients within the tolerances above,
   both bitwise equal on repeat, and other seeds change the output; at
   N=48 in bf16 the forward's two layout routes timed as in 2.
2d. The aggregate forward kernel against plain: ``triplet_aggregate_fwd``
   against ``triplet_aggregate_fwd_reference`` at b=16, N in {24, 40, 48,
   56}, edge width 256, 16 triplet heads, bf16 and f32, the training
   micro-batch (b=32, N=48, bf16) and the F3 shapes, with a padded and a
   fully masked sample; the out direction's pair-transposed V view at b=32
   in bf16 and f32. Tolerances as in 2. Each call takes the route
   ``agg_fwd_route`` names (bf16 up to N=56: the tensor-core body; f32 and
   N=80/128: the panel route); two launches bitwise equal. One JSON line
   per case with the kernel's, the plain version's and the library call's
   times (``torch.einsum``) and the bound; at N=48 in bf16 (b=16 and b=32)
   also their back-to-back device times (``device_ms``), the body and the
   panel route timed in turns on the same inputs, which must agree within
   the bf16 tolerance, and the body's device time at the partition
   ``agg_fwd_blocks`` picks and at its neighbours. Also stage 2's
   training micro-batch, b=64, at N=48 and bucket 56, and its eval batch,
   b=128, N=48, bf16, each with the back-to-back device times of the
   kernel, its plain version and the einsum, as at bucket 56, b=16 (the
   8-head blocks).
2e. The aggregate backward against plain: dA and dV on the same cases with
   a random cotangent, the transposed V included; each call takes the route
   ``agg_bwd_route`` names (bf16: the tensor-core body; f32: the panel
   route); two launches bitwise equal; the library time is that of the two
   einsums of dA and dV. At N=48 in bf16 (b=16 and b=32): the back-to-back
   device times of the kernel, its plain version and the einsums, and the
   body and the panel route timed in turns on the same inputs, which must
   agree within the bf16 tolerance; the same device times at stage 2's
   micro-batch, b=64, N=48 and 56.
2f, 2g. The legacy pair (``use_pallas: true``) against its plain versions
   on phase 2's cases, both directions stacked on the head axis (2 x 16
   heads, head-major), ungated with the constant gate 30.0; tolerances,
   determinism and library times as in 2 and 2b. 2g reports the share of
   dv's error in max|ref|, and at N=48 in bf16 times the backward with and
   without the split of the weights for dv, in turns.
2v. The forward kernels at the draw-stacked batches of ``mc_mode="vmap"``
   (10 draws x 16 molecules = 160 rows): rows 1 (``triplet_dense_fwd``), 2
   (the same at Path D's rate 0.1 with (160, 1) row seeds), 4
   (``triplet_aggregate_fwd``) and 6 (``triplet_attention_fwd``) at N=48
   and 56, and row 1 at the CLI evaluate's 10 x 64 = 640 rows, N=48; bf16,
   gated; within 1e-2 of max|ref| of the plain version, bitwise equal on
   repeat; per-call, back-to-back, plain and library times and the bound.
2r. Row 1 past 2**31 elements per tensor (the published 50 prediction
   draws x 64 reach 3,200 rows): 3,700 rows at N=48 (in place) and 2,800
   at N=56 (head-major copies, rate 0.1); rows on both sides of element
   2**31 must equal the kernel on those rows alone bit for bit (rows are
   independent), or the wrapper must refuse the shape with a clear error
   before launch.
3. Serving at full width: the flagship TGT-At distance model of
   configs/pcqm/tgt_at_200m/dist_pred/tgt_at_dp_rdkit.yaml (24 layers,
   node 768, edge 256, 64 heads, 16 triplet heads, 256 bins, bf16) with
   weights from a seed, on the card; three timed requests of 64 new
   molecules, then one of 16 per bucket, through
   ``DistancePredictor.predict`` and ``predict_bins`` with batch_size 16
   and 10 MC-dropout draws, each request under ``mc_mode`` map and vmap
   in turns (the order alternating). Checks finite outputs, bins
   probabilities that sum to 1, shapes, that every bucket was served, and
   that every triplet core ran the kernel: 48 launches per forward, one
   forward per draw under map and one per device batch under vmap. Before
   the requests, the first request of a fresh vmap predictor cold and
   after ``warmup()``. Then, per bucket, one device batch under map and
   vmap in turns (map, vmap, vmap, map): wall ms, molecules/s and peak
   memory (``max_memory_allocated``) of each; and vmap against map in f32
   at every bucket on one checkpoint of the config cut to 4 layers (full
   width), 10 draws: within 1e-4 of max|ref|. Then one device batch per
   bucket in deterministic f32 through the kernel and through the plain
   path: logits agree to 1e-3 max|ref|.
4. Training at full width and depth: the same config (bf16, remat, its
   dropouts and drop path) on synthetic molecules of up to 48 atoms,
   ``Trainer.train_epoch`` for one epoch of 256 molecules: 4 optimizer
   steps of 2 accumulated micro-batches of 32. Checks finite losses, the
   guard's ``ok`` on every step, that every parameter moved, and the kernel
   launches (per micro-batch 48 backward, and 48 + 46 forward, the 46 being
   the remat replay of the 23 inner layers). Prints ms per step (CUDA
   events) and molecules/s after the first step.
4b. f32 gradients: one micro-batch of 32 through the trained weights in
   f32 via the kernels and via the plain path, same seed (the core draws no
   random numbers, so both draw the same masks): loss to 1e-5 relative,
   every parameter's gradient to 1e-3 of its max|ref|, and non-zero
   gradients on the triplet projections.
3d, 4d, 4bd. Phases 3, 4 and 4b for Path D: the same config with
   ``triplet_dropout: 0.1`` set by the caller (the yaml's own activation-
   dropout rate; no published config sets it), so every MC draw and
   training step runs the dense pair at rate > 0, counted apart
   (``dropout_launches``: 48 per served forward, 752 forward and 384
   backward over the training run, and no rate-0 launch); the f32
   gradients are held against the same model with the core swapped for
   its plain version, which draws the same seeds and masks. The
   deterministic checks of phase 3 are not repeated.
3l, 4l, 4bl. Phases 3, 4 and 4b for Path L: the same config with
   ``use_pallas: True``, through the legacy pair, one launch for both
   directions: 24 forward launches per served forward; per training
   micro-batch 24 + 23 forward and 24 backward, 376 and 192 over the run.
5, 6, 6b. Phases 3, 4 and 4b for TGT-Agx2, the aggregate variant:
   configs/pcqm/tgt_agx2_100m/dist_pred/tgt_agx2_dp_rdkit.yaml (12 layers
   applied twice each, node 768, edge 256, 64 heads, 16 triplet heads) with
   ``use_pallas: dense`` set by the caller, through the aggregate kernels:
   48 forward launches per served forward (2 directions x 12 layers x 2
   applications); per training micro-batch 48 + 44 forward (the remat
   replay of the 11 inner layers, twice each) and 48 backward, 736 and 384
   over the run; every bf16 forward and backward launch of the served and
   trained paths through the bodies (``body_launches``), and the f32
   forwards of 6b through the panel route.
4r. The remat policies and IndivConfig at full width and depth: the
   flagship TGT-At config trains 3 optimizer steps of one micro-batch of
   32 (N up to 48, bf16) under each ``remat_policy`` (``none``, ``dots``,
   ``tri_a``, ``proj``, ``tri_va``), in two passes over the policies (the
   second in reverse order), each from the same weights: ms per step
   (CUDA events), peak memory (``torch.cuda.max_memory_allocated``) and
   launches (per micro-batch 94 + 48, and 48 + 48 under ``tri_va``, whose
   replay takes the saved kernel output); then one f32 micro-batch per
   policy under deterministic algorithms, whose loss and gradients must
   equal ``none``'s to 1e-6 of each gradient's max|ref| (``none`` is also
   run without them, which shows the embedding backward's run-to-run
   spread). Then one served forward (16 molecules at N=48, one draw) of
   an IndivConfig model at full width and depth whose layers alternate
   the attention and aggregate variants, every fourth without a triplet
   sub-layer: each kernel launched twice per layer that carries it, the
   aggregate ones through the body.
7. The CLI at full width and depth, in a temporary directory: the port's
   ``write_synthetic_dataset`` writes 256 molecules of up to 48 atoms in
   the PCQM4Mv2 parquet format (train-3d 168, valid-3d 24, valid 64);
   ``tgt_torch.cli.execute`` runs ``train`` with the published TGT-At yaml
   and ``dataset_path``, ``save_path_prefix``, ``global_batch_size: 64``
   and ``num_epochs: 1``, then ``train`` again with ``num_epochs: 2`` (a
   resume), ``evaluate`` and ``predict``. Checks the counters and the two
   history.yaml entries after the resume, finite losses, results.yaml, the
   bins50 parquet of train and valid read back through the port's ``Bins``
   column, one request served by ``DistancePredictor.from_model_dir``, and
   every command's dense-kernel launches against the count its micro-batches
   and draws imply (per training micro-batch 94 + 48, per forward 48) with
   no call of the plain core; then an f32 ``evaluate`` with
   ``predict_in_train: false`` through the kernel and with ``use_pallas:
   false``: val losses within 1e-4 relative; and the f32 logits of the
   first eval batch (b=64) through both: max|diff| <= 1e-4 max|ref|. A
   planted fault (the kernel's output scaled by 0.9) must fail that logits
   check; its val loss is printed beside the others. Prints wall seconds
   per command, ms per training step and molecules/s evaluated.
7b. Stage 2 of the published pipeline, in phase 7's directory, on its
   data, its distance model and the bins50 it predicted for train and
   valid: ``execute("train")`` with the published TGT-At pretrain yaml
   (``global_batch_size: 64``: one micro-batch of the published 64 per
   step, ``num_epochs: 1``), with the finetune yaml (the same, plus
   ``bins_input_path`` and ``pretrained_weights_file``: the bins50 and the
   pretrain checkpoint), with the gap_pred yaml (the trim of the finetune
   checkpoint), ``execute("evaluate")`` of the gap_pred dir, then three
   timed requests of 64 molecules through ``TwoStagePredictor.
   from_model_dirs`` (phase 7's distance dir and the gap_pred dir, batch 16,
   10 draws in each stage): the first, the first with its sizes reversed
   and the draws' seeds reset (the same molecule must get the same gap:
   input order), and another. Checks finite losses, every step applied,
   the finetune validation, the trimmed checkpoint (no distance head, no
   last-layer triplet), results.yaml, gaps of shape (64,) and finite, and
   every command's and request's dense-kernel launches against the count
   its micro-batches and draws imply (per multi micro-batch 94 + 48, per
   multi draw 48, per gap draw 46) with no call of the plain core; then an
   f32 ``evaluate`` of the gap_pred dir with ``predict_in_train: false``
   through the kernel and with ``use_pallas: false``: MAEs within 1e-4
   relative; and the f32 gaps of the first eval batch (b=128, bins sample
   0) through both: max|diff| <= 1e-4 max|ref|, which the planted fault
   must fail, and the same for the edge stream after the gap model's last
   triplet sub-layer (a forward hook), the closer output. Prints wall
   seconds per command, ms per finetune step (CUDA events), molecules/s
   evaluated, and the two-stage molecules/s and p50.
7v. The MC-draw schedule through the CLI, in phase 7's directory on its
   distance dir and phase 7b's gap_pred dir: ``execute("evaluate")`` under
   ``mc_eval_mode`` map and vmap in turns, in bf16 (launches exact: 480
   under map, 48 under vmap, whose one forward has 640 rows) and in f32
   (val losses within 1e-4 relative), with each pass's molecules/s and
   peak memory; three 64-molecule ``TwoStagePredictor`` requests under
   ``mc_mode`` map and vmap in turns (launches exact: 3,760 and 376), and
   one f32 request of 16 molecules, vmap against map within 1e-4 of
   max|ref|.
7x, 7bx. Phases 7 and 7b for TGT-Agx2, in the same directory on the same
   parquet: the published rdkit chain of ``configs/pcqm/tgt_agx2_100m/``
   (dist_pred, pretrain, finetune, gap_pred) with ``use_pallas: dense``
   set by the caller, through the aggregate kernels: per forward 48
   launches (44 for the gap model, whose last layer has no triplet
   sub-layer), per training micro-batch 48 + 44 forward and 48 backward,
   every bf16 launch through the bodies; the planted fault scales the
   aggregate kernel's output.
7p. The real-data runbook on a PCQM4Mv2 stand-in, in phase 7's directory:
   256 molecules of the port's synthetic generator (4-48 atoms; 192 train,
   32 valid, 32 test-dev, and 8 test-challenge that must be left out) go
   through stand-ins of what the preparation takes from ogb and rdkit (an
   SDF supplier carrying each train molecule's DFT coordinates, two with
   explicit hydrogens, ``smiles2graph``, the OGB dataset with its split and
   targets, ``Chem`` and ``AllChem``); ``build_pcqm_records`` (with the
   port's ``_mol2graph``) and ``write_dataset`` write records.parquet,
   dft_coords.parquet and splits.npz (train-3d 144, valid-3d 48, from
   ``train3d_split``), ``build_rdkit_coords`` rdkit_coords.parquet (four
   molecules take the 2D fallback, one has no conformers, one a leading
   dummy atom). Every row read back through the port's ``PCQM4Mv2Dataset``
   must equal its source molecule after the structural transform, with its
   target and coordinates; ``structural.backend()`` must be "native", and
   the native transform bitwise equal to numpy on all 256 molecules (median
   microseconds per molecule of each, beside the host CPU's model). Then
   ``execute("train")`` of the published TGT-At yaml on the prepared
   directory (``global_batch_size: 64``, one epoch: 3 steps) and
   ``execute("evaluate")``: finite losses, every step applied, and the
   dense launches exact (per training micro-batch 94 + 48, per draw 48, no
   plain core); ms per step from CUDA events beside a ``StepTimer``
   summary. Then the distance model at seed 0 (101,160,258 parameters) is
   saved as a reference ``model_state.pt``, converted by ``python -m
   tgt_torch.models.convert`` in a subprocess, and served from a model dir
   around the ``.npz`` by ``DistancePredictor.from_model_dir``: one
   16-molecule request and one deterministic forward, bitwise equal to the
   in-memory model's with the same seeds, 48 launches per draw. A served
   forward at b=16, N=48 under ``tgt_torch.utils.profiling.trace`` must
   write a Chrome trace under ``chiprun_out/trace_7p/`` that names the
   dense forward kernel; ``flops_estimate`` of one forward is printed.
7d. Data parallelism on the card, in phase 7's directory, on its parquet:
   (a) two ranks, each a subprocess of this script (``--ddp-worker``) in a
   gloo group on cuda:0 (``initialize_distributed(..., backend="gloo",
   device="cuda:0")``: gloo moves CUDA tensors through host memory, so two
   ranks can share one card for the step's all-reduce and broadcast),
   ``execute("train")`` of the published TGT-At yaml with
   ``global_batch_size: 64`` (32 a rank, no accumulation, one epoch of 3
   steps), then ``execute("evaluate")`` and an f32 evaluate
   (``predict_in_train: false``) by both. Checks finite losses, every
   step applied, both ranks' histories equal (1e-6 relative, wall times
   excepted), rank 0 alone wrote (rank 1 trains into a model dir of its
   own, which must stay empty), the dense launches exact on each rank (per
   training micro-batch 94 + 48, per draw 48) with no plain-core call,
   equal evaluate metrics on both ranks, and the f32 evaluate of the two
   ranks within 1e-4 relative of one process's. (b) The f32 global
   gradient, every dropout 0, deterministic algorithms: 16 molecules of
   4-16 atoms on rank 0 and 16 of 40-48 on rank 1; the ranks' all-reduced
   gradient within 1e-4 of max|ref| of one process's on all 32, which a
   planted fault, the average of each rank's own mean (plain DDP), must
   fail. (c) A one-rank NCCL group takes the same gradient through the same
   code, bitwise equal to the one with no group. Prints ms per step on each
   rank (CUDA events) with the all-reduce's share, each rank's peak
   memory, the gradient's and the fault's max|diff|, and the NCCL version.
   Gloo on one card says nothing of NCCL across cards.
7q. The pair axis on the card, in phase 7's directory, on its parquet:
   (a) the two ranks of one pair group (D=1, P=2), each a subprocess of
   this script (``--pair-worker``) in a gloo group on cuda:0, through the
   ``gloo-host`` transport (every pair collective staged through pinned
   host memory), run ``execute("train")`` of the published TGT-At yaml
   with ``num_pair_devices: 2`` and ``use_pallas: false`` (tgt_tpu refuses
   Pallas under a pair mesh), global batch 32, one epoch on the 64
   molecules of the ``valid`` split (2 steps), then ``execute("evaluate")``
   (1 draw), and 3 timed steps on one global batch of 32 molecules (16 of
   4-16 atoms, 16 of 40-48). Checks: 0 launches of every kernel counter
   and 0 plain-core calls, every step applied with finite losses, equal
   losses, histories and evaluate metrics on both ranks, rank 0 alone
   wrote, each rank's ``e`` in every pair-sharded layer application is
   (b, N/2, N, 256). (b) The f32 gradient (every dropout 0, deterministic
   algorithms) of 16 molecules of 40-48 atoms through the pair path within
   1e-4 of max|ref| of one process's on the plain path, for TGT-At and for
   TGT-Agx2 at 4 layers (full width); a planted fault, the ring placing
   block t at ``my`` instead of ``(my - t) mod P``, must fail it. (c) A
   one-rank NCCL group through the same pair path (transport ``nccl``):
   the gradient bitwise equal to the one with no group. Prints ms per step
   on each rank and one process's on the same batch, the pair collectives'
   calls, bytes and ms per step (CUDA events around each), each rank's
   peak memory against one process's, and the transport's name.
8. The kernels line (six kernels, launches by path, with the vmap paths
   ``serving_vmap`` (TGT-At; TGT-Agx2's aggregate forward),
   ``serving_dropout_vmap`` (Path D), ``serving_legacy_vmap`` (Path L),
   ``evaluate_vmap`` and ``two_stage_vmap`` (phase 7v), the forward rows
   at the draw-stacked batches (``vmap_batches``) and row 1 past 2**31
   elements (``past_2_31``), with the dense pair's
   ``prep`` path (phase 7p), its ``ddp`` path (phase 7d, both ranks' train
   and evaluate), every kernel's ``pair`` path (phase 7q: 0, the pair path
   runs none), its stage-2 paths ``pretrain``, ``finetune``,
   ``gap_pred`` and ``two_stage``, its ``remat_<policy>`` training and the IndivConfig
   forward, and the aggregate pair's ``cli`` and stage-2 paths; the
   aggregate pair's rows at bucket 56 and stage 2's shapes; the dense
   pair's dropout launches and rate > 0 times,
   the ungated times and SDPA's at b=16 and b=32, the aggregate pair's
   back-to-back times, body launches and two routes, the dense forward at
   the eval batches b=64 and b=128 and the dense backward at stage 2's
   micro-batch b=64), then ``{"ok": true, "device": {...}}`` as the last
   line.

Each phase prints its wall seconds. Every JSON row is also appended to
``chiprun_out/chip_smoke_rows.jsonl``, which the run starts empty.

It needs no network and imports nothing of JAX; without a CUDA device, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_YAML = os.path.join(
    REPO, "configs", "pcqm", "tgt_at_200m", "dist_pred", "tgt_at_dp_rdkit.yaml")
AGX2_YAML = os.path.join(
    REPO, "configs", "pcqm", "tgt_agx2_100m", "dist_pred",
    "tgt_agx2_dp_rdkit.yaml")


def stage2_yamls(family: str, prefix: str) -> dict:
    """Stage 2 of a family's published rdkit chain: pretrain, finetune and
    gap_pred (phases 7b and 7bx)."""
    return {name: os.path.join(REPO, "configs", "pcqm", family, name, file)
            for name, file in (("pretrain", f"{prefix}_tp.yaml"),
                               ("finetune", f"{prefix}_tp_rdkit.yaml"),
                               ("gap_pred", f"{prefix}_tp_rdkit.yaml"))}

# H100 SXM data-sheet peaks (dense): device memory, and the rate of the
# operations' type (bf16 inputs: tensor cores; f32: the f32 units)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
MODEL_TOL = 1e-3
RATE = 0.3          # the dropout rate of the kernel phase 2c
ROWS_PATH = os.path.join(REPO, "chiprun_out", "chip_smoke_rows.jsonl")


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def emit(row: dict) -> None:
    """Print one JSON row and append it to ROWS_PATH (the end of a long
    output may be all that a caller keeps)."""
    line = json.dumps(row)
    print(line, flush=True)
    with open(ROWS_PATH, "a") as f:
        f.write(line + "\n")


# mangled-name prefixes of the tensor-core bodies' kernels, which must not
# spill: the attention backward (tgt_torch/csrc/triplet_bwd_mma.cuh,
# namespace tbwd), the attention forward (triplet_fwd_mma.cuh, namespace
# tfwd), the aggregate backward (triplet_aggregate_bwd.cu, namespace tagb)
# and the aggregate forward (triplet_aggregate_fwd.cu, namespace tagf)
BODY_PREFIXES = ("_ZN4tbwd", "_ZN4tfwd", "_ZN4tagb", "_ZN4tagf")


def ptxas_report(log: str) -> list:
    """[function, registers, spill store bytes, spill load bytes] for each
    function of one library's ``-Xptxas -v`` log."""
    fns = []
    for ln in log.splitlines():
        props = re.search(r"Function properties for (\S+)", ln)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           ln)
        used = re.search(r"Used (\d+) registers", ln)
        if props:
            fns.append([props.group(1), None, None, None])
        elif spills and fns:
            fns[-1][2:] = [int(spills.group(1)), int(spills.group(2))]
        elif used and fns:
            fns[-1][1] = int(used.group(1))
    return fns


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` single-call times from CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call when calls run back to back: a spin kernel
    holds the card while the host queues ``reps`` calls behind it, so the
    events between the first and the last time the card's work and not the
    host's launch overhead (which ``time_ms`` includes)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)       # ~25 ms at the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_times(row, kernel, plain, library=None):
    """Add the back-to-back device times of the kernel, its plain version
    and (ungated) the library call to a row."""
    row["device_ms"] = device_ms(kernel)
    row["plain_device_ms"] = device_ms(plain)
    if library is not None:
        row["library_device_ms"] = device_ms(library)


# -- phase 2: kernel against plain ------------------------------------------

def core_inputs(b, n, w, h, dtype, gated, gen):
    """q (pre-scaled), k, v, bias, gate of one direction: sample 1 padded,
    sample 2 fully masked, head 5's bias 300 below the other heads'."""
    d = w // h

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q = randn(b, n, n, d, h) * d ** -0.5
    k, v = randn(b, n, n, d, h), randn(b, n, n, d, h)
    node_mask = torch.ones(b, n, device="cuda")
    node_mask[1, n - 7:] = 0
    node_mask[2] = 0
    pair = node_mask[:, :, None] * node_mask[:, None, :]
    mask = ((1.0 - pair) * -1e9)[..., None]
    bias = randn(b, n, n, h) + mask
    bias[..., 5] -= 300.0
    gate = randn(b, n, n, h) + mask if gated else None
    return tuple(None if x is None else x.to(dtype)
                 for x in (q, k, v, bias, gate))


def bound(inputs, out, dtype):
    """Least time (ms) for the function on this card: each input read and
    the output written once over the memory rate, against the QK and AV
    multiply-adds (4*d per (b, j, i, k, h)) over the dtype's peak rate."""
    q = inputs[0]
    b, n, _, d, h = q.shape
    nbytes = sum(x.numel() * x.element_size() for x in inputs if x is not None)
    nbytes += out.numel() * out.element_size()
    flops = 4.0 * b * n ** 3 * h * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# The ungated cores are one PyTorch call: scaled_dot_product_attention with
# the bias as an additive mask (the legacy pair's constant gate of 30.0 has a
# sigmoid of exactly 1.0 in f32). Its fused backends take 4-D (B, H, L, E)
# tensors with E contiguous: B is the row j and H the pair (b, h), whose
# (i, k) bias broadcasts over j. The first backend of SDPA_BACKENDS that
# runs the call is timed and named.
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def dense_as_sdpa(q, k, v, bias, dva=None):
    """The dense core's operands as SDPA's: copies to (j, b*h, i|k, d), the
    mask (1, b*h, i, k) and the cotangent like q. The copies are made here,
    outside the timed call."""
    b, n, _, d, h = q.shape

    def heads(x, order):
        return x.permute(*order).contiguous().reshape(n, b * h, n, d)

    out = (heads(q, (2, 0, 4, 1, 3)), heads(k, (1, 0, 4, 2, 3)),
           heads(v, (1, 0, 4, 2, 3)),
           bias.permute(0, 3, 1, 2).contiguous().reshape(1, b * h, n, n))
    return out if dva is None else out + (heads(dva, (1, 0, 4, 2, 3)),)


def legacy_as_sdpa(q_t, k_t, v_t, bias, dout=None):
    """The legacy core's head-major operands as SDPA's (j, b*h, i|k, d)
    views (no copy), the mask (1, b*h, i, k) and the cotangent like q."""
    b, h, nj, n, d = q_t.shape

    def heads(x):
        return x.permute(2, 0, 1, 3, 4).reshape(nj, b * h, n, d)

    out = (heads(q_t), heads(k_t), heads(v_t), bias.reshape(1, b * h, n, n))
    return out if dout is None else out + (heads(dout),)


def sdpa_call(scale, q, k, v, mask, dout=None):
    """(call, backend): SDPA's forward on these inputs or, given the output
    cotangent ``dout``, its backward, under the first backend of
    SDPA_BACKENDS that runs it; (None, None) if none does."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")     # why a backend declined
                if dout is None:
                    def fwd():
                        return sdpa(q, k, v, attn_mask=mask, scale=scale)
                    fwd()
                    torch.cuda.synchronize()
                    call = fwd
                else:
                    leaves = [x.detach().requires_grad_()
                              for x in (q, k, v, mask)]
                    out = sdpa(*leaves[:3], attn_mask=leaves[3], scale=scale)

                    def bwd():
                        return torch.autograd.grad(out, leaves, dout,
                                                   retain_graph=True)
                    bwd()
                    torch.cuda.synchronize()
                    call = bwd
        except RuntimeError:
            continue

        def under_backend(call=call, backend=backend):
            with sdpa_kernel([backend]):
                return call()
        return under_backend, name
    return None, None


def sdpa_time(scale, q, k, v, mask, dout=None):
    """(ms, backend) of SDPA's forward on these inputs or, given the output
    cotangent ``dout``, of its backward; (None, None) if no backend runs."""
    call, name = sdpa_call(scale, q, k, v, mask, dout)
    return (None, None) if call is None else (time_ms(call), name)


# (b, N, edge width, dtype, gated): the serving grid at b=16, then the
# training micro-batch of the flagship config (b=32 molecules of up to 48
# atoms, bf16), gated and ungated, so that SDPA is timed at the shape the
# kernels run at in training; 16 triplet heads throughout
WIDTH = 256
KERNEL_CASES = [(16, n, WIDTH, dtype, gated) for n in (24, 40, 48, 56)
                for dtype in (torch.bfloat16, torch.float32)
                for gated in (True, False)] + [
                    (32, 48, WIDTH, torch.bfloat16, gated)
                    for gated in (True, False)]
# branches no published bucket reaches: n = 80 and 128 (the backward body's
# sums in device memory above n = 64) at b=4, which keeps the plain
# versions' (b, j, h, i, k) tensors near 0.5 GB, and head widths 8 and 32
# (edge widths 128 and 512 over 16 heads; d = 8 is padded to 16 in bf16)
F3_CASES = [case for dtype in (torch.bfloat16, torch.float32) for case in (
    (4, 80, WIDTH, dtype, True), (4, 128, WIDTH, dtype, True),
    (16, 48, 128, dtype, True), (16, 48, 512, dtype, True))]
CASES = KERNEL_CASES + F3_CASES
# the published eval batches that the CLI's validation, evaluation and
# prediction run at: stage 1's b=64 (batch_size 32 x prediction_bmult 2)
# and stage 2's b=128 (64 x 2); b=64 is also stage 2's training
# micro-batch; phase 2 only
EVAL_CASES = [(64, n, WIDTH, torch.bfloat16, True) for n in (48, 56)] + [
    (128, 48, WIDTH, torch.bfloat16, True)]
# the backward at stage 2's training micro-batch, b=64 (pretrain and
# finetune: batch_size 64), at N=48 and at bucket 56 (head-major copies);
# phase 2b only
STAGE2_BWD_CASES = [(64, n, WIDTH, torch.bfloat16, True) for n in (48, 56)]


# the cases the kernels line reports: b=16, N=48, bf16, gated (and ungated,
# whose library time SDPA gives), and the ungated training micro-batch
FLAGSHIP = (16, 48, WIDTH, torch.bfloat16, True)
UNGATED = (16, 48, WIDTH, torch.bfloat16, False)
UNGATED_TRAIN = (32, 48, WIDTH, torch.bfloat16, False)


def repeats(case) -> bool:
    """The cases whose kernels run twice on the same inputs, held bitwise
    equal: every bf16 case at N=48, every F3 case and every case of the
    eval and stage-2 batches."""
    b, n, w, dtype, gated = case
    return ((n == 48 and w == WIDTH and dtype == torch.bfloat16)
            or case in F3_CASES + EVAL_CASES + STAGE2_BWD_CASES)


def timed(case) -> bool:
    """The cases whose plain version is timed beside the kernel: all but the
    F3 cases, which check branches and are not on a path."""
    return case not in F3_CASES


def same_outputs(got, again) -> bool:
    return all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(got, again))


def dense_routes(inputs, seed=None, rate=0.0):
    """The two layout routes of the bf16 dense forward on the same inputs,
    timed in turns (in place, copies, copies, in place): their ms, the
    copies alone, and the largest difference between their outputs."""
    from tgt_torch.ops.kernels import triplet_dense as td

    def inplace():
        return td._fwd_inplace(*inputs, seed, rate)

    def copies():
        return td._fwd_mma(*inputs, seed, rate)

    a, c = inplace(), copies()
    times = [time_ms(f) for f in (inplace, copies, copies, inplace)]
    return {"ms_in_place": [times[0], times[3]],
            "ms_head_major_copies": [times[1], times[2]],
            "copies_alone_ms": relayout_ms(*inputs[:3], back=1),
            "routes_max_abs_diff": float((a.float() - c.float()).abs().max())}


def kernel_phase(card):
    from tgt_torch.ops.kernels.triplet_dense import (
        reads_in_place, triplet_dense_fwd, triplet_dense_fwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for case in CASES + EVAL_CASES:
        b, n, w, dtype, gated = case
        inputs = core_inputs(b, n, w, 16, dtype, gated, gen)
        out = triplet_dense_fwd(*inputs)
        torch.cuda.synchronize()
        ref = triplet_dense_fwd_reference(*inputs)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        ok = (bool(torch.isfinite(out.float()).all())
              and err <= KERNEL_TOL[dtype] * scale
              and not (gated and bool(out[2].any())))   # fully masked sample
        row = {"case": "triplet_dense_fwd", "b": b, "n": n,
               "edge_width": w, "heads": 16, "dtype": dtype_name(dtype),
               "gated": gated, "max_abs_err": err, "max_abs_ref": scale,
               "tol": KERNEL_TOL[dtype] * scale, "ok": ok,
               "route": ("in place" if dtype == torch.bfloat16
                         and reads_in_place(*inputs) else
                         "head-major copies" if dtype == torch.bfloat16
                         else "f32 CUDA cores"), "card": card}
        if repeats(case):
            row["bitwise_equal"] = torch.equal(out, triplet_dense_fwd(*inputs))
            ok &= row["bitwise_equal"]
        row["ms"] = time_ms(lambda: triplet_dense_fwd(*inputs))
        if timed(case):
            row["plain_ms"] = time_ms(
                lambda: triplet_dense_fwd_reference(*inputs))
            row["bound_ms"], row["bound_by"] = bound(inputs, out, dtype)
            row["library_ms"], row["library"] = (None, None) if gated else \
                sdpa_time(1.0, *dense_as_sdpa(*inputs[:4]))
        if n == 48 and w == WIDTH and dtype == torch.bfloat16:
            row.update(dense_routes(inputs))
        if (n == 48 and w == WIDTH and dtype == torch.bfloat16) or \
                case in EVAL_CASES:
            device_times(row, lambda: triplet_dense_fwd(*inputs),
                         lambda: triplet_dense_fwd_reference(*inputs),
                         None if gated else sdpa_call(
                             1.0, *dense_as_sdpa(*inputs[:4]))[0])
        emit(row)
        if not ok:
            fail(f"kernel disagrees with its plain version: {row}")
        rows[case] = row
        del inputs, out, ref

    # the out direction's pair-transposed K and V views at the training
    # micro-batch
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias, gate = core_inputs(32, 48, WIDTH, 16, dtype, True, gen)
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        out = triplet_dense_fwd(q, k, v, bias, gate)
        ref = triplet_dense_fwd_reference(q, k, v, bias, gate)
        err = float((out.float() - ref.float()).abs().max())
        tol = KERNEL_TOL[dtype] * float(ref.float().abs().max())
        ok = bool(torch.isfinite(out.float()).all()) and err <= tol
        row = {"case": "triplet_dense_fwd transposed k/v", "b": 32, "n": 48,
               "dtype": dtype_name(dtype), "max_abs_err": err, "tol": tol,
               "ok": ok}
        if dtype == torch.bfloat16:
            row.update(dense_routes((q, k, v, bias, gate)))
        emit(row)
        if not ok:
            fail(f"kernel disagrees on the transposed k/v views in {dtype}")
        del q, k, v, bias, gate, out, ref
    return rows


# -- phase 2b: the backward kernel against plain -----------------------------

BWD_NAMES = ("dq", "dk", "dv", "dbias", "dgate")


def bwd_bound(inputs, dva, grads, dtype):
    """Least time (ms) of the backward: q, k, v, bias, gate and dva read,
    dq, dk, dv, dbias and dgate written once over the memory rate, against
    its five products (10*d flops per (b, j, i, k, h)) over the peak rate."""
    b, n, _, d, h = inputs[0].shape
    nbytes = sum(x.numel() * x.element_size()
                 for x in (*inputs, dva, *grads) if x is not None)
    flops = 10.0 * b * n ** 3 * h * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare_bwd(got, ref, dtype):
    """Per-output max |kernel - plain| and its tolerance; (errs, ok)."""
    errs, ok = {}, True
    for name, g, r in zip(BWD_NAMES, got, ref):
        if r is None:
            ok &= g is None
            continue
        err = float((g.float() - r.float()).abs().max())
        tol = KERNEL_TOL[dtype] * float(r.float().abs().max())
        errs[name] = [err, tol]
        ok &= bool(torch.isfinite(g.float()).all()) and err <= tol
    return errs, ok


def relayout_ms(q, *kv, back):
    """Time of the bf16 dense wrappers' copies alone: q and the (b, j, k,
    d, h) tensors ``kv`` to head-major, then the first ``back`` of them
    back, as the wrappers make them around a body (the forward's head-major
    route: k, v and one back; the backward: k, v, dva and three back)."""
    from tgt_torch.ops.kernels.triplet_bwd_panel import padded_head_dim
    from tgt_torch.ops.kernels.triplet_dense import (
        KV_ORDER, Q_ORDER, from_head_major, to_head_major)

    d = q.shape[3]
    dp = padded_head_dim(d)

    def copies():
        moved = [(to_head_major(q, Q_ORDER, dp), Q_ORDER)] + [
            (to_head_major(x, KV_ORDER, dp), KV_ORDER) for x in kv]
        return [from_head_major(t, order, d) for t, order in moved[:back]]
    return time_ms(copies)


def backward_kernel_phase(card):
    from tgt_torch.ops.kernels.triplet_dense import (
        triplet_dense_bwd, triplet_dense_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for case in CASES + STAGE2_BWD_CASES:
        b, n, w, dtype, gated = case
        inputs = core_inputs(b, n, w, 16, dtype, gated, gen)
        dva = torch.randn(inputs[0].shape, device="cuda",
                          generator=gen).to(dtype)
        got = triplet_dense_bwd(*inputs, dva)
        torch.cuda.synchronize()
        ref = triplet_dense_bwd_reference(*inputs, dva)
        errs, ok = compare_bwd(got, ref, dtype)
        row = {"case": "triplet_dense_bwd", "b": b, "n": n,
               "edge_width": w, "heads": 16, "dtype": dtype_name(dtype),
               "gated": gated, "errs": errs,
               "max_abs_err": max(e for e, _ in errs.values()), "ok": ok,
               "ms": time_ms(lambda: triplet_dense_bwd(*inputs, dva)),
               "card": card}
        if repeats(case):
            row["bitwise_equal"] = same_outputs(
                got, triplet_dense_bwd(*inputs, dva))
        if timed(case):
            row["plain_ms"] = time_ms(
                lambda: triplet_dense_bwd_reference(*inputs, dva))
            row["bound_ms"], row["bound_by"] = bwd_bound(inputs, dva, got,
                                                         dtype)
            row["library_ms"], row["library"] = (None, None) if gated else \
                sdpa_time(1.0, *dense_as_sdpa(*inputs[:4], dva))
        if n == 48 and w == WIDTH and dtype == torch.bfloat16:
            row["relayout_ms"] = relayout_ms(*inputs[:3], dva, back=3)
        if case in STAGE2_BWD_CASES:
            device_times(row, lambda: triplet_dense_bwd(*inputs, dva),
                         lambda: triplet_dense_bwd_reference(*inputs, dva))
        emit(row)
        if not ok:
            fail(f"backward kernel disagrees with its plain version: "
                 f"{row}")
        if row.get("bitwise_equal") is False:
            fail(f"two backward launches on the same inputs differ: {row}")
        rows[case] = row
        del inputs, dva, got, ref

    # the out direction's pair-transposed K and V views, read in place, at
    # the training micro-batch
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias, gate = core_inputs(32, 48, WIDTH, 16, dtype, True, gen)
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        dva = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        got = triplet_dense_bwd(q, k, v, bias, gate, dva)
        ref = triplet_dense_bwd_reference(q, k, v, bias, gate, dva)
        errs, ok = compare_bwd(got, ref, dtype)
        emit({"case": "triplet_dense_bwd transposed k/v", "b": 32,
                          "n": 48, "dtype": str(dtype).replace("torch.", ""),
                          "errs": errs, "ok": ok})
        if not ok:
            fail(f"backward kernel disagrees on the transposed k/v views "
                 f"in {dtype}")
        del q, k, v, bias, gate, dva, got, ref
    return rows


# -- phase 2c: the dense pair at rate > 0 against plain ----------------------

# phase 2b's cases, then the out direction's pair-transposed K/V views at
# the training micro-batch: (b, N, edge width, dtype, gated, transposed K/V)
DROPOUT_CASES = [case + (False,) for case in CASES] + [
    (32, 48, WIDTH, dtype, True, True)
    for dtype in (torch.bfloat16, torch.float32)]


def dropout_kernel_phase(card):
    """Phase 2c; returns the forward and backward rows at (16, 48, bf16,
    gated)."""
    from tgt_torch.ops.kernels.triplet_dense import (
        triplet_dense_bwd, triplet_dense_bwd_reference, triplet_dense_fwd,
        triplet_dense_fwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(4)
    flagship = {}
    for b, n, w, dtype, gated, transposed in DROPOUT_CASES:
        case = (b, n, w, dtype, gated)
        inputs = core_inputs(b, n, w, 16, dtype, gated, gen)
        if transposed:
            q, k, v, bias, gate = inputs
            inputs = (q, k.transpose(1, 2), v.transpose(1, 2), bias, gate)
        seed = torch.randint(0, 2 ** 31 - 1, (b, 1), device="cuda",
                             generator=gen, dtype=torch.int32)
        dva = torch.randn(inputs[0].shape, device="cuda",
                          generator=gen).to(dtype)
        out = triplet_dense_fwd(*inputs, seed, RATE)
        ref = triplet_dense_fwd_reference(*inputs, seed, RATE)
        err = float((out.float() - ref.float()).abs().max())
        tol = KERNEL_TOL[dtype] * float(ref.float().abs().max())
        other = triplet_dense_fwd(*inputs, seed + 1, RATE)
        reseeded = not torch.equal(out, other)
        fwd_same = torch.equal(out, triplet_dense_fwd(*inputs, seed, RATE))
        got = triplet_dense_bwd(*inputs, dva, seed, RATE)
        ref_g = triplet_dense_bwd_reference(*inputs, dva, seed, RATE)
        errs, bwd_ok = compare_bwd(got, ref_g, dtype)
        again = triplet_dense_bwd(*inputs, dva, seed, RATE)
        same = all(x is None and y is None or torch.equal(x, y)
                   for x, y in zip(got, again))
        torch.cuda.synchronize()
        fwd_ok = bool(torch.isfinite(out.float()).all()) and err <= tol
        common = {"b": b, "n": n, "edge_width": w, "heads": 16,
                  "dtype": dtype_name(dtype), "gated": gated,
                  "transposed_kv": transposed, "rate": RATE, "card": card}
        rows = ({"case": "triplet_dense_fwd dropout", **common,
                 "max_abs_err": err, "tol": tol, "ok": fwd_ok,
                 "reseeded_differs": reseeded, "bitwise_equal": fwd_same},
                {"case": "triplet_dense_bwd dropout", **common, "errs": errs,
                 "max_abs_err": max(e for e, _ in errs.values()),
                 "ok": bwd_ok, "bitwise_equal": same})
        if n == 48 and w == WIDTH and dtype == torch.bfloat16:
            rows[0].update(dense_routes(inputs, seed, RATE))
        if not transposed and timed(case):
            seed_b = (seed,)
            rows[0].update(
                ms=time_ms(lambda: triplet_dense_fwd(*inputs, seed, RATE)),
                plain_ms=time_ms(lambda: triplet_dense_fwd_reference(
                    *inputs, seed, RATE)), library_ms=None)
            rows[0]["bound_ms"], rows[0]["bound_by"] = bound(
                inputs + seed_b, out, dtype)
            rows[1].update(
                ms=time_ms(lambda: triplet_dense_bwd(*inputs, dva, seed,
                                                     RATE)),
                plain_ms=time_ms(lambda: triplet_dense_bwd_reference(
                    *inputs, dva, seed, RATE)), library_ms=None)
            rows[1]["bound_ms"], rows[1]["bound_by"] = bwd_bound(
                inputs + seed_b, dva, got, dtype)
        for row in rows:
            emit(row)
        if not (fwd_ok and bwd_ok):
            fail(f"the dropout kernels disagree with their plain versions: "
                 f"{rows}")
        if not reseeded:
            fail("the dropout forward ignored its seeds")
        if not (same and fwd_same):
            fail("two dropout launches on the same inputs differ")
        if case == FLAGSHIP and not transposed:
            flagship = {"fwd": rows[0], "bwd": rows[1]}
        del inputs, out, ref, other, got, ref_g, again, dva
    return flagship


# -- phases 2d and 2e: the aggregate kernels against plain --------------------

def agg_inputs(b, n, w, h, dtype, gen):
    """Weights a (b, i, k, h) = softmax_k(e) * sigmoid(g) and v (b, j, k, d,
    h) of one direction: sample 1 padded, sample 2 fully masked (its
    weights are exact zeros, so its output is zero)."""
    d = w // h

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    node_mask = torch.ones(b, n, device="cuda")
    node_mask[1, n - 7:] = 0
    node_mask[2] = 0
    pair = node_mask[:, :, None] * node_mask[:, None, :]
    mask = ((1.0 - pair) * -1e9)[..., None]
    a = (torch.softmax(randn(b, n, n, h) + mask, dim=2)
         * torch.sigmoid(randn(b, n, n, h) + mask))
    return a.to(dtype), randn(b, n, n, d, h).to(dtype)


def agg_bound(tensors, flops_per_unit, dtype):
    """Least time (ms): each tensor read or written once over the memory
    rate, against ``flops_per_unit`` * N^3 * b * d * h flops over the
    dtype's peak rate."""
    b, n, _, d, h = tensors[1].shape
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops_per_unit * b * n ** 3 * d * h / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# (b, N, edge width, dtype, transposed V): the serving grid at b=16, the
# training micro-batch, the out direction's pair-transposed V view at b=32,
# and the F3 shapes
AGG_CASES = [(16, n, WIDTH, dtype, False) for n in (24, 40, 48, 56)
             for dtype in (torch.bfloat16, torch.float32)] + [
                 (32, 48, WIDTH, torch.bfloat16, False)] + [
                 (32, 48, WIDTH, dtype, True)
                 for dtype in (torch.bfloat16, torch.float32)] + [
                 (b, n, w, dtype, False) for b, n, w, dtype, _ in F3_CASES]


# stage 2's training micro-batch, b=64 (batch_size 64), at N=48 and bucket
# 56, for both phases, and its eval batch, b=128 (64 x prediction_bmult 2),
# N=48, for the forward: bf16, each with its back-to-back device times
AGG_STAGE2_CASES = [(64, n, WIDTH, torch.bfloat16, False) for n in (48, 56)]
AGG_EVAL_CASES = [(128, 48, WIDTH, torch.bfloat16, False)]
# the shapes whose back-to-back device times the kernels line reports by
# shape: bucket 56 at b=16 (the forward's 8-head blocks) and stage 2's
AGG_DEVICE_SHAPES = {(16, 56), (64, 48), (64, 56), (128, 48)}


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def agg_fwd_routes(a, v, tol):
    """The bf16 body and the panel route of the aggregate forward on the
    same inputs: per call in turns (body, panel, panel, body), back to back,
    and the largest difference between their outputs against the
    tolerance."""
    from tgt_torch.ops.kernels.triplet_aggregate import triplet_aggregate_fwd

    def body():
        return triplet_aggregate_fwd(a, v)

    def panel():
        return triplet_aggregate_fwd(a, v, _panel_route=True)

    diff = float((body().float() - panel().float()).abs().max())
    times = [time_ms(f) for f in (body, panel, panel, body)]
    return {"ms_body": [times[0], times[3]],
            "ms_panel_route": [times[1], times[2]],
            "device_ms_panel_route": device_ms(panel),
            "routes_max_abs_diff": diff, "routes_agree": diff <= tol}


def agg_fwd_partitions(a, v, ref, tol):
    """Back-to-back device times of the forward body at the partition
    ``agg_fwd_blocks`` picks and at its neighbours (half and twice the rows
    j with 16 heads, 4 and 8 chunks of j with 8), each held to the plain
    version: {"<heads>x<rows j>": ms}."""
    from tgt_torch.ops.kernels.triplet_aggregate import (
        _fwd_body, agg_fwd_blocks)
    from tgt_torch.ops.kernels.triplet_bwd_panel import sm_count

    b, n, _, d, h = v.shape
    hb, jc = agg_fwd_blocks(b, n, d, h, sm_count(v.device))
    times = {}
    for x, y in sorted({(hb, jc), (16, max(1, jc // 2)), (16, 2 * jc),
                        (8, -(-n // 4)), (8, -(-n // 8))}):
        rc, out = _fwd_body(a, v, x, y)
        torch.cuda.synchronize()
        if rc != 0 or float((out.float() - ref.float()).abs().max()) > tol:
            fail(f"the forward body at {x} heads and {y} rows j per block "
                 f"failed (CUDA error {rc}) or disagrees")
        times[f"{x}x{y}"] = device_ms(lambda: _fwd_body(a, v, x, y))
    return times


def aggregate_kernel_phase(card):
    """Phase 2d; returns the rows at (16, 48, bf16) and (32, 48, bf16) by
    b, and the bf16 rows of ``AGG_DEVICE_SHAPES`` by (b, N)."""
    from tgt_torch.ops.kernels.triplet_aggregate import (
        agg_fwd_route, triplet_aggregate_fwd, triplet_aggregate_fwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, by_shape = {}, {}
    for b, n, w, dtype, transposed in (AGG_CASES + AGG_STAGE2_CASES
                                       + AGG_EVAL_CASES):
        a, v = agg_inputs(b, n, w, 16, dtype, gen)
        if transposed:
            v = v.transpose(1, 2)   # the out direction's view, read in place
        route = agg_fwd_route(dtype, n, w // 16, 16, v.stride()[:3], True)
        body_before = triplet_aggregate_fwd.body_launches
        out = triplet_aggregate_fwd(a, v)
        torch.cuda.synchronize()
        took_body = triplet_aggregate_fwd.body_launches > body_before
        ref = triplet_aggregate_fwd_reference(a, v)
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        tol = KERNEL_TOL[dtype] * scale
        ok = (took_body == (route == "body")
              and bool(torch.isfinite(out.float()).all()) and err <= tol
              and not bool(out[2].any()))          # the fully masked sample
        same = torch.equal(out, triplet_aggregate_fwd(a, v))
        ms = time_ms(lambda: triplet_aggregate_fwd(a, v))
        plain_ms = time_ms(lambda: triplet_aggregate_fwd_reference(a, v))
        library_ms = time_ms(lambda: torch.einsum("bikh,bjkdh->bjidh", a, v))
        bound_ms, bound_by = agg_bound((a, v, out), 2.0, dtype)
        row = {"case": "triplet_aggregate_fwd", "b": b, "n": n,
               "edge_width": w, "heads": 16, "dtype": dtype_name(dtype),
               "transposed_v": transposed, "route": route,
               "max_abs_err": err, "max_abs_ref": scale, "tol": tol,
               "ok": ok, "bitwise_equal": same, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms, "card": card}
        if n == 48 and b in (16, 32) and w == WIDTH and \
                dtype == torch.bfloat16 and not transposed:
            row.update(agg_fwd_routes(a, v, tol),
                       partitions_device_ms=agg_fwd_partitions(a, v, ref, tol))
            device_times(row, lambda: triplet_aggregate_fwd(a, v),
                         lambda: triplet_aggregate_fwd_reference(a, v),
                         lambda: torch.einsum("bikh,bjkdh->bjidh", a, v))
            ok &= row["routes_agree"]
            rows[b] = row
        if (b, n) in AGG_DEVICE_SHAPES and dtype == torch.bfloat16:
            device_times(row, lambda: triplet_aggregate_fwd(a, v),
                         lambda: triplet_aggregate_fwd_reference(a, v),
                         lambda: torch.einsum("bikh,bjkdh->bjidh", a, v))
            by_shape[b, n] = row
        emit(row)
        if not ok:
            fail(f"aggregate kernel disagrees with its plain version or took "
                 f"another route: {row}")
        if not same:
            fail(f"two aggregate forward launches differ: {row}")
        del a, v, out, ref
    return rows, by_shape


def agg_bwd_routes(a, v, dva, tol):
    """The bf16 body and today's route of the aggregate backward on the same
    inputs: per call in turns (body, panel, panel, body), back to back, and
    the largest difference between their outputs against the tolerance."""
    from tgt_torch.ops.kernels.triplet_aggregate import triplet_aggregate_bwd

    def body():
        return triplet_aggregate_bwd(a, v, dva)

    def panel():
        return triplet_aggregate_bwd(a, v, dva, _panel_route=True)

    diff = [float((x.float() - y.float()).abs().max())
            for x, y in zip(body(), panel())]
    times = [time_ms(f) for f in (body, panel, panel, body)]
    return {"ms_body": [times[0], times[3]],
            "ms_panel_route": [times[1], times[2]],
            "device_ms_panel_route": device_ms(panel),
            "routes_max_abs_diff": diff,
            "routes_agree": all(x <= t for x, t in zip(diff, tol))}


def aggregate_backward_phase(card):
    """Phase 2e; returns the rows at (16, 48, bf16) and (32, 48, bf16) by
    b, and those at stage 2's micro-batch by (b, N)."""
    from tgt_torch.ops.kernels.triplet_aggregate import (
        agg_bwd_route, triplet_aggregate_bwd, triplet_aggregate_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, by_shape = {}, {}
    for b, n, w, dtype, transposed in AGG_CASES + AGG_STAGE2_CASES:
        a, v = agg_inputs(b, n, w, 16, dtype, gen)
        if transposed:
            v = v.transpose(1, 2)
        dva = torch.randn(v.shape, device="cuda", generator=gen).to(dtype)
        route = agg_bwd_route(dtype, n, w // 16, 16, v.stride()[:3], True)
        body_before = triplet_aggregate_bwd.body_launches
        got = triplet_aggregate_bwd(a, v, dva)
        torch.cuda.synchronize()
        took_body = triplet_aggregate_bwd.body_launches > body_before
        ref = triplet_aggregate_bwd_reference(a, v, dva)
        errs, ok = {}, took_body == (route == "body")
        for name, g, r in zip(("da", "dv"), got, ref):
            err = float((g.float() - r.float()).abs().max())
            tol = KERNEL_TOL[dtype] * float(r.float().abs().max())
            errs[name] = [err, tol]
            ok &= bool(torch.isfinite(g.float()).all()) and err <= tol
        again = triplet_aggregate_bwd(a, v, dva)
        same = all(torch.equal(x, y) for x, y in zip(got, again))

        def einsums():
            return (torch.einsum("bjidh,bjkdh->bikh", dva, v),
                    torch.einsum("bikh,bjidh->bjkdh", a, dva))

        ms = time_ms(lambda: triplet_aggregate_bwd(a, v, dva))
        plain_ms = time_ms(lambda: triplet_aggregate_bwd_reference(a, v, dva))
        library_ms = time_ms(einsums)
        bound_ms, bound_by = agg_bound((a, v, dva, *got), 4.0, dtype)
        row = {"case": "triplet_aggregate_bwd", "b": b, "n": n,
               "edge_width": w, "heads": 16, "dtype": dtype_name(dtype),
               "transposed_v": transposed, "route": route, "errs": errs,
               "max_abs_err": max(e for e, _ in errs.values()), "ok": ok,
               "bitwise_equal": same, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "card": card}
        if n == 48 and b in (16, 32) and w == WIDTH and \
                dtype == torch.bfloat16 and not transposed:
            row.update(agg_bwd_routes(a, v, dva,
                                      [t for _, t in errs.values()]))
            device_times(row, lambda: triplet_aggregate_bwd(a, v, dva),
                         lambda: triplet_aggregate_bwd_reference(a, v, dva),
                         einsums)
            ok &= row["routes_agree"]
            rows[b] = row
        if (b, n, w, dtype, transposed) in AGG_STAGE2_CASES:
            device_times(row, lambda: triplet_aggregate_bwd(a, v, dva),
                         lambda: triplet_aggregate_bwd_reference(a, v, dva),
                         einsums)
            by_shape[b, n] = row
        emit(row)
        if not ok:
            fail(f"aggregate backward disagrees with its plain version or "
                 f"took another route: {row}")
        if not same:
            fail(f"two aggregate backward launches differ: {row}")
        del a, v, dva, got, ref, again
    return rows, by_shape


# -- phases 2f and 2g: the legacy pair against plain -------------------------

def legacy_inputs(b, n, w, h, dtype, gated, gen):
    """q_t, k_t, v_t (b, 2h, N, N, d) and bias, gate (b, 2h, N, N): both
    directions stacked on the head axis, as the model passes them; sample
    1 padded, sample 2 fully masked; ungated, the constant gate 30.0."""
    d = w // h

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    q, k, v = (randn(b, 2 * h, n, n, d) for _ in range(3))
    node_mask = torch.ones(b, n, device="cuda")
    node_mask[1, n - 7:] = 0
    node_mask[2] = 0
    pair = node_mask[:, :, None] * node_mask[:, None, :]
    mask = ((1.0 - pair) * -1e9)[:, None]
    bias = randn(b, 2 * h, n, n) + mask
    gate = (randn(b, 2 * h, n, n) + mask if gated
            else torch.full_like(bias, 30.0))
    return tuple(x.to(dtype) for x in (q, k, v, bias, gate))


def legacy_bound(tensors, flops_per_unit, dtype):
    """Least time (ms): each tensor read or written once over the memory
    rate, against ``flops_per_unit`` * d per (b, h, j, i, k) over the
    dtype's peak rate."""
    b, h, nj, n, d = tensors[0].shape
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops_per_unit * d * b * h * nj * n * n / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def legacy_forward_phase(card):
    """Phase 2f; returns the rows by case."""
    from tgt_torch.ops.kernels.triplet_attention import (
        triplet_attention_fwd, triplet_core_fwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for case in CASES:
        b, n, w, dtype, gated = case
        inputs = legacy_inputs(b, n, w, 16, dtype, gated, gen)
        scale = (w // 16) ** -0.5
        out = triplet_attention_fwd(*inputs, scale)
        torch.cuda.synchronize()
        ref = triplet_core_fwd_reference(*inputs, scale)
        err = float((out.float() - ref.float()).abs().max())
        tol = KERNEL_TOL[dtype] * float(ref.float().abs().max())
        ok = (bool(torch.isfinite(out.float()).all()) and err <= tol
              and not (gated and bool(out[2].any())))   # fully masked sample
        row = {"case": "triplet_attention_fwd", "b": b, "n": n,
               "edge_width": w, "heads": "2 x 16", "dtype": dtype_name(dtype),
               "gated": gated, "max_abs_err": err, "tol": tol, "ok": ok,
               "ms": time_ms(lambda: triplet_attention_fwd(*inputs, scale)),
               "card": card}
        if repeats(case):
            row["bitwise_equal"] = torch.equal(
                out, triplet_attention_fwd(*inputs, scale))
            ok &= row["bitwise_equal"]
        if timed(case):
            row["plain_ms"] = time_ms(
                lambda: triplet_core_fwd_reference(*inputs, scale))
            row["bound_ms"], row["bound_by"] = legacy_bound((*inputs, out),
                                                            4.0, dtype)
            row["library_ms"], row["library"] = (None, None) if gated else \
                sdpa_time(scale, *legacy_as_sdpa(*inputs[:4]))
        if n == 48 and w == WIDTH and dtype == torch.bfloat16:
            device_times(row, lambda: triplet_attention_fwd(*inputs, scale),
                         lambda: triplet_core_fwd_reference(*inputs, scale),
                         None if gated else sdpa_call(
                             scale, *legacy_as_sdpa(*inputs[:4]))[0])
        emit(row)
        if not ok:
            fail(f"legacy forward disagrees with its plain version: {row}")
        rows[case] = row
        del inputs, out, ref
    return rows


def split_cost(inputs, dout, scale):
    """The legacy bf16 backward with and without the split of the weights
    for dv, in turns (split, high part alone, alone, split): the ms of each
    and the dv error share of the high part alone."""
    from tgt_torch.ops.kernels import triplet_attention as tl

    def split():
        return tl._bwd_mma(*inputs, dout, scale, split_dv=True)

    def alone():
        return tl._bwd_mma(*inputs, dout, scale, split_dv=False)

    ref = tl.triplet_core_bwd_reference(*inputs, dout, scale)[2].float()
    dv_alone = alone()[2].float()
    times = [time_ms(f) for f in (split, alone, alone, split)]
    return {"ms_split": [times[0], times[3]], "ms_unsplit": [times[1], times[2]],
            "dv_share_unsplit": float((dv_alone - ref).abs().max())
            / float(ref.abs().max())}


def legacy_backward_phase(card):
    """Phase 2g; returns the rows by case."""
    from tgt_torch.ops.kernels.triplet_attention import (
        triplet_attention_bwd, triplet_core_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = {}
    for case in CASES:
        b, n, w, dtype, gated = case
        inputs = legacy_inputs(b, n, w, 16, dtype, gated, gen)
        scale = (w // 16) ** -0.5
        dout = torch.randn(inputs[0].shape, device="cuda",
                           generator=gen).to(dtype)
        got = triplet_attention_bwd(*inputs, dout, scale)
        torch.cuda.synchronize()
        ref = triplet_core_bwd_reference(*inputs, dout, scale)
        errs, ok = compare_bwd(got, ref, dtype)
        row = {"case": "triplet_attention_bwd", "b": b, "n": n,
               "edge_width": w, "heads": "2 x 16", "dtype": dtype_name(dtype),
               "gated": gated, "errs": errs,
               "max_abs_err": max(e for e, _ in errs.values()), "ok": ok,
               "dv_share": errs["dv"][0] / float(ref[2].float().abs().max()),
               "ms": time_ms(
                   lambda: triplet_attention_bwd(*inputs, dout, scale)),
               "card": card}
        if repeats(case):
            row["bitwise_equal"] = same_outputs(
                got, triplet_attention_bwd(*inputs, dout, scale))
        if timed(case):
            row["plain_ms"] = time_ms(
                lambda: triplet_core_bwd_reference(*inputs, dout, scale))
            row["bound_ms"], row["bound_by"] = legacy_bound(
                (*inputs, dout, *got), 10.0, dtype)
            row["library_ms"], row["library"] = (None, None) if gated else \
                sdpa_time(scale, *legacy_as_sdpa(*inputs[:4], dout))
        if n == 48 and w == WIDTH and dtype == torch.bfloat16:
            row.update(split_cost(inputs, dout, scale))
        emit(row)
        if not ok:
            fail(f"legacy backward disagrees with its plain version: {row}")
        if row.get("bitwise_equal") is False:
            fail(f"two legacy backward launches differ: {row}")
        rows[case] = row
        del inputs, dout, got, ref
    return rows


# -- phases 2v and 2r: the forward kernels at the draw-stacked batches ----------

VMAP_DRAWS = 10     # the published evaluation_samples: draws per device batch
# rows 1, 2, 4 and 6 at the draw-stacked batch of vmap serving, 10 draws x
# 16 molecules, at N=48 (the in-place loader and 16-head aggregate blocks)
# and bucket 56 (head-major copies, 8-head blocks); row 1 also at the CLI
# evaluate's 10 draws x 64; bf16, gated
VMAP_SERVE_B = VMAP_DRAWS * 16
VMAP_CASES = [(VMAP_SERVE_B, n, WIDTH, torch.bfloat16, True)
              for n in (48, 56)]
VMAP_EVAL_CASES = [(VMAP_DRAWS * 64, 48, WIDTH, torch.bfloat16, True)]
VMAP_RATE = 0.1     # Path D's triplet_dropout


def vmap_kernel_row(card, name, case, kernel, plain, inputs, out_bound,
                    library=None):
    """One kernel against its plain version at a draw-stacked batch: the
    bf16 tolerance of max|ref|, bitwise equal on repeat, its time per call
    and back to back, the plain version's and the library call's, and the
    bound."""
    b, n, w, dtype, _ = case
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    same = torch.equal(out, kernel())
    bound_ms, bound_by = out_bound(out)
    row = {"case": name, "b": b, "n": n, "edge_width": w, "heads": 16,
           "dtype": dtype_name(dtype), "max_abs_err": err,
           "max_abs_ref": scale, "tol": KERNEL_TOL[dtype] * scale,
           "bitwise_equal": same,
           "ok": (bool(torch.isfinite(out.float()).all())
                  and err <= KERNEL_TOL[dtype] * scale and same),
           "ms": time_ms(kernel, reps=10), "plain_ms": time_ms(plain, reps=5),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None if library is None else time_ms(library,
                                                              reps=10),
           "device_ms": device_ms(kernel, reps=10), "card": card}
    emit(row)
    if not row["ok"]:
        fail(f"{name} disagrees with its plain version at b={b}: {row}")
    return row


def vmap_kernel_phase(card):
    """Phase 2v: rows 1, 2, 4 and 6 at the draw-stacked batches; returns
    {kernel name: {(b, N): row}}."""
    from tgt_torch.ops.kernels.triplet_aggregate import (
        triplet_aggregate_fwd, triplet_aggregate_fwd_reference)
    from tgt_torch.ops.kernels.triplet_attention import (
        triplet_attention_fwd, triplet_core_fwd_reference)
    from tgt_torch.ops.kernels.triplet_dense import (
        triplet_dense_fwd, triplet_dense_fwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = {k: {} for k in ("triplet_dense_fwd", "triplet_dense_fwd dropout",
                            "triplet_aggregate_fwd", "triplet_attention_fwd")}
    for case in VMAP_CASES + VMAP_EVAL_CASES:
        b, n, w, dtype, gated = case
        inputs = core_inputs(b, n, w, 16, dtype, gated, gen)
        rows["triplet_dense_fwd"][b, n] = vmap_kernel_row(
            card, "triplet_dense_fwd", case,
            lambda: triplet_dense_fwd(*inputs),
            lambda: triplet_dense_fwd_reference(*inputs), inputs,
            lambda out: bound(inputs, out, dtype))
        if case in VMAP_CASES:
            seed = torch.randint(0, 2 ** 31 - 1, (b, 1), device="cuda",
                                 generator=gen, dtype=torch.int32)
            rows["triplet_dense_fwd dropout"][b, n] = vmap_kernel_row(
                card, "triplet_dense_fwd dropout", case,
                lambda: triplet_dense_fwd(*inputs, seed, VMAP_RATE),
                lambda: triplet_dense_fwd_reference(*inputs, seed, VMAP_RATE),
                inputs, lambda out: bound(inputs, out, dtype))
        del inputs
        if case not in VMAP_CASES:
            continue
        a, v = agg_inputs(b, n, w, 16, dtype, gen)
        rows["triplet_aggregate_fwd"][b, n] = vmap_kernel_row(
            card, "triplet_aggregate_fwd", case,
            lambda: triplet_aggregate_fwd(a, v),
            lambda: triplet_aggregate_fwd_reference(a, v), (a, v),
            lambda out: agg_bound((a, v, out), 2.0, dtype),
            lambda: torch.einsum("bikh,bjkdh->bjidh", a, v))
        del a, v
        legacy = legacy_inputs(b, n, w, 16, dtype, gated, gen)
        scale = (w // 16) ** -0.5
        rows["triplet_attention_fwd"][b, n] = vmap_kernel_row(
            card, "triplet_attention_fwd", case,
            lambda: triplet_attention_fwd(*legacy, scale),
            lambda: triplet_core_fwd_reference(*legacy, scale), legacy,
            lambda out: legacy_bound((*legacy, out), 4.0, dtype))
        del legacy
        torch.cuda.empty_cache()
    return rows


# Past 2**31 elements per tensor: the published prediction_samples (50)
# at stage 1's eval batch (64) make 3,200 rows, and q, k, v at bucket 56
# then hold 2.57e9 elements each. Rows are independent, so the kernel's
# rows of a batch past 2**31 elements must equal, bit for bit, the kernel
# on those rows alone (no N^3 plain version needed); the rows checked
# straddle element 2**31. One shape per bf16 route of row 1: in place at
# N=48 (3,700 rows) and the head-major copies at bucket 56 (2,800 rows,
# at Path D's dropout rate, whose keep mask hashes per-row indices).
BIG_CASES = [(3700, 48, 0.0), (2800, 56, VMAP_RATE)]


def big_batch_phase(card):
    """Phase 2r: row 1 (and row 2) at a batch past 2**31 elements, held
    row for row against the same rows alone, or refused with a clear error
    before launch; returns the rows."""
    from tgt_torch.ops.kernels.triplet_dense import triplet_dense_fwd

    gen = torch.Generator(device="cuda").manual_seed(8)
    out_rows = []
    for b, n, rate in BIG_CASES:
        torch.cuda.reset_peak_memory_stats()
        h, d = 16, WIDTH // 16
        bf = torch.bfloat16

        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen, dtype=bf)

        q = randn(b, n, n, d, h) * d ** -0.5
        k, v = randn(b, n, n, d, h), randn(b, n, n, d, h)
        bias, gate = randn(b, n, n, h), randn(b, n, n, h)
        seed = (torch.randint(0, 2 ** 31 - 1, (b, 1), device="cuda",
                              generator=gen, dtype=torch.int32)
                if rate else None)
        per_row = n * n * d * h
        mid = min(2 ** 31 // per_row, b - 2)    # the row of element 2**31
        picked = torch.tensor([0, 1, mid - 1, mid, mid + 1, b - 1],
                              device="cuda")
        row = {"case": "triplet_dense_fwd past 2**31 elements", "b": b,
               "n": n, "rate": rate, "elements_per_tensor": b * per_row,
               "rows_checked": picked.tolist(), "card": card}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = triplet_dense_fwd(q, k, v, bias, gate, seed, rate)
        except (ValueError, RuntimeError) as exc:
            row.update(refused=str(exc), ok="2**31" in str(exc) or
                       "at most" in str(exc))
            emit(row)
            if not row["ok"]:
                fail(f"the kernel at {b} x {n} failed without a clear "
                     f"error: {exc}")
            out_rows.append(row)
            continue
        torch.cuda.synchronize()
        row["ms"] = (time.perf_counter() - t0) * 1e3
        alone = triplet_dense_fwd(
            q[picked], k[picked], v[picked], bias[picked], gate[picked],
            None if seed is None else seed[picked].contiguous(), rate)
        row["bitwise_equal"] = torch.equal(out[picked], alone)
        row["finite"] = bool(torch.isfinite(out[picked].float()).all())
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        row["ok"] = row["bitwise_equal"] and row["finite"]
        emit(row)
        if not row["ok"]:
            fail(f"rows of the batch past 2**31 elements differ from the "
                 f"same rows alone: {row}")
        out_rows.append(row)
        del q, k, v, bias, gate, seed, out, alone
        torch.cuda.empty_cache()
    return out_rows


# -- phase 3: serving ---------------------------------------------------------

def random_molecule(rs: np.random.RandomState, n: int) -> dict:
    """A connected molecule-like graph (spanning tree + ~15% ring bonds)
    with OGB-style integer features and coordinates."""
    edges = {(int(rs.randint(0, j)), j) for j in range(1, n)}
    for _ in range(int(0.15 * n)):
        i, j = rs.randint(0, n, 2)
        if i != j:
            edges.add((int(min(i, j)), int(max(i, j))))
    edges = sorted(edges)
    both = np.array(edges + [(j, i) for i, j in edges], np.int64).reshape(-1, 2)
    ef = rs.randint(0, 5, size=(len(edges), 3)).astype(np.int16)
    return {"num_nodes": n, "edges": both,
            "node_features": rs.randint(0, 60, size=(n, 9)).astype(np.int16),
            "edge_features": np.concatenate([ef, ef]),
            "rdkit_coords": (rs.randn(n, 3) * 1.5).astype(np.float32)}


def request(rs: np.random.RandomState, k: int = 64) -> list:
    """48 sizes drawn as round(exp(N(2.6, 0.4))) clipped to [4, 56], as
    benchmarks/serving_bench.py draws them, plus 16 uniform in 33..56."""
    sizes = np.clip(np.round(np.exp(rs.normal(2.6, 0.4, size=k - 16))), 4, 56)
    sizes = np.concatenate([sizes, rs.randint(33, 57, size=16)]).astype(int)
    return [random_molecule(rs, int(n)) for n in sizes]


def bucket_sweep(rs: np.random.RandomState, buckets, k: int) -> list:
    """``k`` molecules sized within each bucket's range, so that the
    size-sorted device batches of ``k`` land one on each bucket."""
    mols, lo = [], 0
    for nb in buckets:
        mols += [random_molecule(rs, int(n))
                 for n in rs.randint(max(lo + 1, 4), nb + 1, size=k)]
        lo = nb
    return mols


def device_batch(mols, buckets):
    """One collated feed on the card, as the predictor builds it."""
    from tgt_torch.data.collate import add_edge_mask, padded_collate
    from tgt_torch.data.structural import AddStructuralData
    from tgt_torch.schemes.commons import coords2dist

    rows = []
    for m in mols:
        row = AddStructuralData()(dict(m))
        row["node_mask"] = np.ones(row["num_nodes"], np.uint8)
        rows.append(row)
    batch = add_edge_mask(padded_collate(rows, buckets=buckets))
    feed = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).cuda()
            for k in ("node_features", "distance_matrix", "feature_matrix",
                      "node_mask", "edge_mask")}
    feed["dist_input"] = coords2dist(
        torch.from_numpy(batch["rdkit_coords"]).cuda().float())
    return feed


class ModelSpec(NamedTuple):
    """A published distance-model config, what the caller sets on it, the
    wrappers of the kernels its triplet layers launch, the counter that
    counts them (``dropout_launches`` for the dense pair at rate > 0), and
    the launches of each wrapper per layer application (2: one per
    direction; 1: the legacy pair serves both directions in one launch), and
    the backward and forward wrappers' counters of the calls that must all
    take their tensor-core bodies (``body_launches`` of the aggregate pair),
    if any; the family's stage-2 yamls, and the name in
    ``tgt_torch.ops.triplet`` of the differentiable kernel core that the
    planted fault scales."""
    name: str
    yaml: str
    overrides: dict
    fwd: Callable
    bwd: Callable
    counter: str = "launches"
    per_layer: int = 2
    body_counter: str = ""
    fwd_body_counter: str = ""
    stage2: dict = {}
    core: str = "triplet_dense"

    def launches(self, wrapper) -> int:
        return getattr(wrapper, self.counter)

    def per_forward(self, cfg) -> int:
        """Triplet launches of one forward of a model whose every layer
        application runs the triplet sub-layer."""
        return self.per_layer * cfg["model_height"] * cfg.get(
            "layer_multiplier", 1)

    def per_layer_applied(self, cfg) -> int:
        """Launches of one layer's ``layer_multiplier`` applications: the
        last layer's, which remat does not replay (and which the gap model
        has without a triplet sub-layer)."""
        return self.per_layer * cfg.get("layer_multiplier", 1)

    def body_counts(self) -> dict:
        """The forward and backward body launches, where the path counts
        them."""
        out = {}
        if self.fwd_body_counter:
            out["fwd_body"] = getattr(self.fwd, self.fwd_body_counter)
        if self.body_counter:
            out["bwd_body"] = getattr(self.bwd, self.body_counter)
        return out


def kernel_counters():
    """Every launch counter of the package: (wrapper, attribute)."""
    from tgt_torch.ops.kernels import triplet_aggregate as ta
    from tgt_torch.ops.kernels import triplet_attention as tl
    from tgt_torch.ops.kernels import triplet_dense as td
    return [(td.triplet_dense_fwd, "launches"),
            (td.triplet_dense_fwd, "dropout_launches"),
            (td.triplet_dense_bwd, "launches"),
            (td.triplet_dense_bwd, "dropout_launches"),
            (ta.triplet_aggregate_fwd, "launches"),
            (ta.triplet_aggregate_fwd, "body_launches"),
            (ta.triplet_aggregate_bwd, "launches"),
            (ta.triplet_aggregate_bwd, "body_launches"),
            (tl.triplet_attention_fwd, "launches"),
            (tl.triplet_attention_bwd, "launches")]


def reset_counts() -> None:
    for wrapper, attr in kernel_counters():
        setattr(wrapper, attr, 0)


def check_only(spec: ModelSpec) -> None:
    """The path launched no kernel but its own, counted by its counter."""
    own = ((spec.fwd, spec.counter), (spec.bwd, spec.counter),
           (spec.bwd, spec.body_counter), (spec.fwd, spec.fwd_body_counter))
    others = {f"{w.__name__}.{a}": getattr(w, a)
              for w, a in kernel_counters()
              if (w, a) not in own and getattr(w, a)}
    if others:
        fail(f"{spec.name} launched other kernels: {others}")


@contextlib.contextmanager
def plain_dense_core():
    """TripletAttention's dense core swapped for the kernels' plain version:
    the same seeds give the same dropout masks, so the model's gradients
    through the kernels can be held against it."""
    import tgt_torch.ops.triplet as tri
    from tgt_torch.ops.kernels.triplet_dense import triplet_dense_fwd_reference

    saved = tri.triplet_dense
    tri.triplet_dense = triplet_dense_fwd_reference
    try:
        yield
    finally:
        tri.triplet_dense = saved


def load_config(spec: ModelSpec, **extra) -> dict:
    from tgt_torch.core.config import load_yaml

    raw = load_yaml(spec.yaml)
    raw.update(spec.overrides, **extra)
    return raw


MODES = ("map", "vmap")     # the MC-draw schedules, timed in turns
F32_SCHEDULE_HEIGHT = 4     # the f32 schedule check's depth (full width)


def warmup_check(card, model, cfg, buckets, mc, bs):
    """The first 16-molecule request of a fresh vmap predictor, cold (the
    process's first request at the draw-stacked batch, on an emptied
    allocator cache) and after ``warmup()`` on an emptied cache: wall
    seconds of each and of the warmup."""
    from tgt_torch.serving import DistancePredictor

    mols = request(np.random.RandomState(5), 16)
    row = {"serving": "warmup", "mc_mode": "vmap", "buckets": list(buckets),
           "card": card}
    for name in ("cold", "warmed"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pred = DistancePredictor(model, cfg, mc_samples=mc, batch_size=bs,
                                 buckets=buckets, seed=0, device="cuda",
                                 mc_mode="vmap")
        if name == "warmed":
            t0 = time.perf_counter()
            pred.warmup()
            row["warmup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = pred.predict(mols)
        row[f"{name}_first_request_s"] = time.perf_counter() - t0
        if not np.isfinite(out).all():
            fail(f"the {name} first request returned non-finite values")
    emit(row)
    return row


def bucket_schedule(card, spec, preds, sweep, buckets, bs):
    """One device batch of ``bs`` molecules per bucket through map and vmap
    in turns (map, vmap, vmap, map): wall ms of each request and its peak
    memory (``max_memory_allocated`` after ``reset_peak_memory_stats``),
    and the molecules/s of the faster schedule's median."""
    out = {}
    for t, nb in enumerate(buckets):
        mols = sweep[t * bs:(t + 1) * bs]
        ms = {m: [] for m in MODES}
        peak = {m: 0.0 for m in MODES}
        for mode in ("map", "vmap", "vmap", "map"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            preds[mode].predict(mols)
            ms[mode].append((time.perf_counter() - t0) * 1e3)
            peak[mode] = max(peak[mode],
                             torch.cuda.max_memory_allocated() / 1e9)
        out[nb] = {**{f"{m}_ms": ms[m] for m in MODES},
                   **{f"{m}_peak_gb": peak[m] for m in MODES},
                   **{f"{m}_molecules_per_s": bs * 1e3 / float(
                       np.median(ms[m])) for m in MODES}}
        out[nb]["faster"] = min(MODES, key=lambda m: np.median(ms[m]))
    emit({"serving": "per bucket, in turns", "path": spec.name,
          "batch": bs, "card": card,
          "buckets": {str(k): v for k, v in out.items()}})
    return out


def f32_schedule_check(card, spec, cfg, buckets, mc, bs, rs):
    """vmap against map in f32 at every bucket, one device batch of ``bs``
    molecules and ``mc`` draws each, on one checkpoint (seed 1) at full
    width cut to ``F32_SCHEDULE_HEIGHT`` layers: max|diff| <= 1e-4
    max|ref| of the MC-averaged probabilities."""
    from tgt_torch.models import make_model
    from tgt_torch.serving import DistancePredictor

    cfg32 = cfg.replace(compute_dtype="float32",
                        model_height=F32_SCHEDULE_HEIGHT)
    model = make_model("distance", cfg32, device="cuda", seed=1)
    preds = {m: DistancePredictor(model, cfg32, mc_samples=mc, batch_size=bs,
                                  buckets=buckets, seed=3, device="cuda",
                                  mc_mode=m) for m in MODES}
    sweep = bucket_sweep(rs, buckets, bs)
    rows = {}
    for t, nb in enumerate(buckets):
        mols = sweep[t * bs:(t + 1) * bs]
        got, ref = preds["vmap"].predict(mols), preds["map"].predict(mols)
        bins_v = preds["vmap"].predict_bins(mols)
        bins_m = preds["map"].predict_bins(mols)
        err = float(np.abs(got - ref).max())
        scale = float(np.abs(ref).max())
        ok = (got.shape == ref.shape and got.shape[1] == nb
              and bool(np.isfinite(got).all()) and err <= 1e-4 * scale)
        rows[nb] = {"max_abs_err": err, "max_abs_ref": scale, "ok": ok,
                    "bins_equal_share": float((bins_v == bins_m).mean())}
        if not ok:
            emit({"schedule_f32": "vmap vs map", "path": spec.name,
                  "n": nb, **rows[nb]})
            fail(f"f32 vmap disagrees with map at bucket {nb}")
    emit({"schedule_f32": "vmap vs map", "path": spec.name,
          "model_height": F32_SCHEDULE_HEIGHT, "draws": mc, "batch": bs,
          "card": card, "buckets": {str(k): v for k, v in rows.items()}})
    return rows


def serving_phase(card, spec: ModelSpec):
    """Phases 3, 3d, 3l and 5; returns the main path's forward launches
    under each MC-draw schedule, {"map": n, "vmap": n}."""
    from tgt_torch.data.collate import pick_bucket
    from tgt_torch.models import make_model
    from tgt_torch.models.heads import DistanceModel
    from tgt_torch.schemes import get_scheme
    from tgt_torch.serving import DistancePredictor

    raw = load_config(spec)
    scheme = get_scheme(raw["scheme"])(raw, command="evaluate")
    cfg = scheme.model_cfg
    buckets = tuple(scheme.cfg.buckets)
    mc, bs = scheme.cfg.evaluation_samples, 16
    t0 = time.time()
    model = make_model("distance", cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit({"model": os.path.relpath(spec.yaml, REPO), "path": spec.name,
                      "triplet_dropout": cfg.triplet_dropout,
                      "params": n_params, "model_height": cfg.model_height,
                      "layer_multiplier": cfg.layer_multiplier,
                      "triplet_type": cfg.triplet_type,
                      "node_width": cfg.node_width,
                      "edge_width": cfg.edge_width,
                      "triplet_heads": cfg.triplet_heads,
                      "num_dist_bins": cfg.num_dist_bins,
                      "compute_dtype": cfg.compute_dtype,
                      "use_pallas": cfg.use_pallas, "mc_samples": mc,
                      "batch_size": bs, "buckets": list(buckets),
                      "init_s": time.time() - t0})
    preds = {m: DistancePredictor(model, cfg, mc_samples=mc, batch_size=bs,
                                  buckets=buckets, seed=0, device="cuda",
                                  mc_mode=m) for m in MODES}
    per_forward = spec.per_layer * cfg.model_height * cfg.layer_multiplier
    rs = np.random.RandomState(0)

    if spec.name == "TGT-At":              # before any vmap request
        warmup_check(card, model, cfg, buckets, mc, bs)
    warm = request(rs, 16)                 # warm-up: cuBLAS and kernel load
    for m in MODES:
        preds[m].predict(warm)
    torch.cuda.synchronize()

    # Size-sorted batches of the timed mix fill buckets 24, 32, 40 and 56
    # but seldom 48; an untimed fourth request sweeps every bucket. Each
    # request goes through map and vmap in turns (the order alternates).
    requests = [request(rs) for _ in range(3)]
    requests.append(bucket_sweep(rs, buckets, bs))

    reset_counts()                         # the main path starts here
    lat = {m: [] for m in MODES}
    lat_bins = {m: [] for m in MODES}
    launched_by = {m: 0 for m in MODES}
    hit = set()
    for r, mols in enumerate(requests):
        sizes = sorted(m["num_nodes"] for m in mols)
        n_batches = math.ceil(len(mols) / bs)
        hit |= {pick_bucket(max(sizes[i:i + bs]), buckets)
                for i in range(0, len(sizes), bs)}
        n_max = max(pick_bucket(s, buckets) for s in sizes)
        times = {}
        for mode in (MODES if r % 2 == 0 else MODES[::-1]):
            # map: one forward per draw; vmap: one of S*b rows per batch
            expect = per_forward * (mc if mode == "map" else 1) * n_batches
            for name, call in (("predict", preds[mode].predict),
                               ("predict_bins", preds[mode].predict_bins)):
                before = spec.launches(spec.fwd)
                t0 = time.perf_counter()
                out = call(mols)
                times[mode, name] = time.perf_counter() - t0
                launched = spec.launches(spec.fwd) - before
                launched_by[mode] += launched
                if launched != expect:
                    fail(f"{name} ({mode}): {launched} kernel launches, "
                         f"expected {expect}")
                if name == "predict":
                    if out.shape != (len(mols), n_max, n_max,
                                     cfg.num_dist_bins):
                        fail(f"predict shape {out.shape}")
                    if not np.isfinite(out).all():
                        fail("predict returned non-finite probabilities")
                    for i, m in enumerate(mols):
                        n = m["num_nodes"]
                        s = out[i, :n, :n].sum(-1)
                        if np.abs(s - 1.0).max() > 1e-3:
                            fail(f"probabilities of molecule {i} sum to "
                                 f"{s.min()}..{s.max()}")
                else:
                    if out.shape != (len(mols), mc, n_max, n_max) or \
                            out.dtype != np.int32:
                        fail(f"predict_bins shape {out.shape} {out.dtype}")
                    if out.min() < 0 or out.max() >= cfg.num_dist_bins:
                        fail("predict_bins out of range")
            if r < 3:
                lat[mode].append(times[mode, "predict"])
                lat_bins[mode].append(times[mode, "predict_bins"])
        emit({"request": r, "molecules": len(mols), "timed": r < 3,
              "device_batches": n_batches,
              **{f"{name}_s_{mode}": v for (mode, name), v in times.items()},
              "launches_per_call": {
                  m: per_forward * (mc if m == "map" else 1) * n_batches
                  for m in MODES}})
    main_launches = spec.launches(spec.fwd)  # the main path ends here
    if main_launches != sum(launched_by.values()):
        fail(f"{main_launches} forward launches, {launched_by} counted")
    body = (getattr(spec.fwd, spec.fwd_body_counter)
            if spec.fwd_body_counter else None)
    if body is not None and body != main_launches:
        fail(f"{body} of {main_launches} forward launches took the body")
    check_only(spec)
    if hit != set(buckets):
        fail(f"served buckets {sorted(hit)}, expected {list(buckets)}")

    for m in MODES:
        p50 = float(np.median(lat[m]))
        emit({
            "serving": "DistancePredictor.predict", "mc_mode": m,
            "path": spec.name, "model": os.path.relpath(spec.yaml, REPO),
            "card": card, "molecules_per_s": 64 / p50, "p50_request_s": p50,
            "request_s": lat[m],
            "predict_bins_p50_s": float(np.median(lat_bins[m])),
            "buckets_hit": sorted(hit), "kernel_launches": launched_by[m],
            "kernel_body_launches": body})
    bucket_schedule(card, spec, preds, bucket_sweep(rs, buckets, bs),
                    buckets, bs)
    del preds
    f32_schedule_check(card, spec, cfg, buckets, mc, bs, rs)
    torch.cuda.empty_cache()

    if spec.counter != "launches":
        # a deterministic forward runs no dropout: the rate-0 checks below
        # would repeat those of the path without it
        return launched_by

    # one deterministic bf16 forward at N=48, b=16: the kernel's share
    feed48 = device_batch([random_molecule(rs, int(n))
                           for n in rs.randint(41, 49, size=bs)], buckets)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(feed48), reps=5)
    emit({"forward": "deterministic bf16", "path": spec.name, "b": bs,
          "n": 48, "forward_ms": fwd_ms, "card": card})

    # every bucket, deterministic f32: kernel path against the plain path
    cfg32 = cfg.replace(compute_dtype="float32")
    state = model.state_dict()
    del model
    paths = {}
    for use_pallas in (cfg.use_pallas, False):
        m = DistanceModel(cfg32.replace(use_pallas=use_pallas), device="cuda")
        m.load_state_dict(state)
        paths[use_pallas] = m.requires_grad_(False)
    sweep = bucket_sweep(rs, buckets, bs)
    for t, nb in enumerate(buckets):
        feed = device_batch(sweep[t * bs:(t + 1) * bs], buckets)
        with torch.inference_mode():
            before = spec.launches(spec.fwd)
            got = paths[cfg.use_pallas](feed)
            if spec.launches(spec.fwd) - before != per_forward:
                fail("the f32 kernel path did not launch the kernel")
            ref = paths[False](feed)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        ok = (got.shape[1] == nb and bool(torch.isfinite(got).all())
              and err <= MODEL_TOL * scale)
        emit({"logits_f32": "kernel vs plain", "path": spec.name, "n": nb,
                          "max_abs_err": err, "max_abs_ref": scale,
                          "ok": ok})
        if not ok:
            fail(f"f32 logits disagree at bucket {nb}")
    return launched_by


# -- phase 4: training ----------------------------------------------------------

def training_scheme(spec: ModelSpec, **extra):
    """A config for training on synthetic molecules of up to 48 atoms, 64
    molecules per optimizer step: accumulation 2 of 32 (``extra`` overrides
    any of it)."""
    from tgt_torch.schemes import get_scheme

    raw = load_config(spec, **dict(dict(
        dataset_source="synthetic", synth_max_nodes=48,
        synth_train_samples=256, global_batch_size=64), **extra))
    return get_scheme(raw["scheme"])(raw, command="train")


def training_phase(card, spec: ModelSpec):
    from tgt_torch.training import Trainer

    scheme = training_scheme(spec)
    cfg = scheme.model_cfg
    trainer = Trainer(scheme, device="cuda")
    if trainer.grad_accum != 2:
        fail(f"accumulation {trainer.grad_accum}, expected 2")
    state = trainer.init_state(seed=0)
    model = state["model"]
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    emit({"train": os.path.relpath(spec.yaml, REPO), "path": spec.name,
                      "triplet_dropout": cfg.triplet_dropout,
                      "params": sum(v.numel() for v in before.values()),
                      "model_height": cfg.model_height,
                      "layer_multiplier": cfg.layer_multiplier,
                      "triplet_type": cfg.triplet_type,
                      "node_width": cfg.node_width,
                      "edge_width": cfg.edge_width,
                      "triplet_heads": cfg.triplet_heads,
                      "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
                      "use_pallas": cfg.use_pallas,
                      "micro_batch": scheme.cfg.batch_size,
                      "accum": trainer.grad_accum})

    # record each step's metrics and a CUDA event at its end
    steps, train_step = [], trainer.train_step

    def recorded(*args, **kwargs):
        state, metrics = train_step(*args, **kwargs)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        steps.append((metrics, end))
        return state, metrics

    trainer.train_step = recorded
    loader = scheme.train_loader(0, 0, 1)   # makes the 256 molecules
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    reset_counts()                                  # the main path starts
    start.record()
    state, logs, stop = trainer.train_epoch(state, loader)
    torch.cuda.synchronize()
    launches = {"fwd": spec.launches(spec.fwd),
                "bwd": spec.launches(spec.bwd)}  # the main path ends
    if spec.body_counter:
        launches["bwd_body"] = getattr(spec.bwd, spec.body_counter)
    if spec.fwd_body_counter:
        launches["fwd_body"] = getattr(spec.fwd, spec.fwd_body_counter)
    check_only(spec)
    n_steps = len(steps)
    per_micro = spec.per_layer * cfg.model_height * cfg.layer_multiplier
    replay = per_micro - spec.per_layer * cfg.layer_multiplier  # remat
    expect = {"fwd": n_steps * trainer.grad_accum * (per_micro + replay),
              "bwd": n_steps * trainer.grad_accum * per_micro}
    if spec.body_counter:            # every backward call took the body
        expect["bwd_body"] = expect["bwd"]
    if spec.fwd_body_counter:        # every forward call took the body
        expect["fwd_body"] = expect["fwd"]
    ends = [start] + [e for _, e in steps]
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    losses = [float(m["loss"]) for m, _ in steps]
    oks = [bool(m["ok"]) for m, _ in steps]
    moved = sum(int(not torch.equal(before[k], v.detach()))
                for k, v in model.named_parameters())
    steady = float(np.median(step_ms[1:]))
    row = {"training": "Trainer.train_epoch", "path": spec.name,
           "model": os.path.relpath(spec.yaml, REPO), "card": card,
           "steps": n_steps,
           "losses": losses, "ok": oks, "stop": stop, "epoch_loss": logs["loss"],
           "step_ms": step_ms, "median_step_ms_after_first": steady,
           "molecules_per_s": 64 / (steady / 1e3),
           "params_moved": moved, "params": len(before),
           "launches": launches, "expected_launches": expect,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    if n_steps != 4 or stop is not None:
        fail(f"{n_steps} optimizer steps (stop {stop}), expected 4")
    if not all(oks) or not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training step: {losses} {oks}")
    if moved != len(before):
        fail(f"only {moved} of {len(before)} parameters moved")
    if launches != expect:
        fail(f"kernel launches {launches}, expected {expect}")
    return launches, model.state_dict()


def gradient_phase(card, spec: ModelSpec, weights):
    """One micro-batch in f32: loss and every parameter's gradient through
    the kernels against the plain path, the same weights and seed. With
    triplet dropout (Path D) the plain side keeps the dense path and swaps
    its core for the kernels' plain version, so both draw the same seeds
    and masks; otherwise it is ``use_pallas: false``, whose dropout draws
    match the kernel path's because the core draws none."""
    from tgt_torch.models.heads import DistanceModel

    scheme = training_scheme(spec)
    cfg32 = scheme.model_cfg.replace(compute_dtype="float32")
    host = next(iter(scheme.train_loader(1, 0, 1)))
    host = {k: v[:scheme.cfg.batch_size] for k, v in host.items()}
    feed = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in scheme.device_batch(host).items()}
    kernel = cfg32.use_pallas
    plain = ((kernel, plain_dense_core) if spec.counter == "dropout_launches"
             else (False, contextlib.nullcontext))
    out = {}
    for name, (use_pallas, context) in (
            ("kernel", (kernel, contextlib.nullcontext)), ("plain", plain)):
        model = DistanceModel(cfg32.replace(use_pallas=use_pallas),
                              device="cuda")
        model.load_state_dict(weights)
        before = spec.launches(spec.bwd)
        body_before = (getattr(spec.fwd, spec.fwd_body_counter)
                       if spec.fwd_body_counter else 0)
        with context():
            loss, _ = scheme.loss_fn(model, feed, seed=7)
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params)
        launched = spec.launches(spec.bwd) - before
        if (launched > 0) != (name == "kernel"):
            fail(f"the {name} side of the f32 gradients launched "
                 f"{launched} backward kernels")
        if spec.fwd_body_counter and \
                getattr(spec.fwd, spec.fwd_body_counter) != body_before:
            fail("an f32 forward call took the bf16 body")
        out[name] = (float(loss.detach()), dict(zip(names, grads)))
        del model, loss, params, grads
    (loss, got), (ref_loss, ref) = out["kernel"], out["plain"]
    worst, bad = 0.0, []
    for k, r in ref.items():
        scale = float(r.abs().max())
        err = float((got[k] - r).abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
        if not math.isfinite(err) or err > MODEL_TOL * scale:
            bad.append((k, err, scale))
    tri = {k: float(g.abs().max()) for k, g in got.items()
           if ".tria." in k and "lin_O" not in k}
    row = {"gradients_f32": "kernel path vs plain path", "path": spec.name,
           "model": os.path.relpath(spec.yaml, REPO), "card": card,
           "n": int(feed["node_features"].shape[1]), "loss": loss,
           "plain_loss": ref_loss, "loss_rel_err": abs(loss - ref_loss)
           / abs(ref_loss), "worst_grad_err_over_max_ref": worst,
           "tensors": len(ref), "bad": bad[:5],
           "min_triplet_projection_grad": min(tri.values())}
    emit(row)
    if abs(loss - ref_loss) > 1e-5 * abs(ref_loss):
        fail(f"f32 loss {loss} against plain {ref_loss}")
    if bad:
        fail(f"{len(bad)} gradients disagree beyond {MODEL_TOL} max|ref|")
    if not min(tri.values()) > 0:
        fail("a triplet projection got no gradient through the kernels")

# -- phase 4r: the remat policies, and an IndivConfig model ------------------------

REMAT_STEPS = 3     # optimizer steps of one micro-batch of 32 per policy
REMAT_GRAD_TOL = 1e-6


def remat_step(spec: ModelSpec, policy: str, weights: dict):
    """``REMAT_STEPS`` optimizer steps of the training micro-batch (b=32,
    molecules of up to 48 atoms, bf16) under ``policy`` from ``weights``:
    ms per step (CUDA events), peak memory and launches."""
    from tgt_torch.training import Trainer

    scheme = training_scheme(spec, remat_policy=policy, global_batch_size=32,
                             synth_train_samples=32 * REMAT_STEPS)
    trainer = Trainer(scheme, device="cuda")
    state = trainer.init_state(seed=0)
    state["model"].load_state_dict(weights)
    ends, train_step = [], trainer.train_step

    def recorded(*args, **kwargs):
        out = train_step(*args, **kwargs)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        ends.append((out[1], end))
        return out

    trainer.train_step = recorded
    loader = scheme.train_loader(0, 0, 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    reset_counts()                                  # the main path starts
    start.record()
    state, logs, stop = trainer.train_epoch(state, loader)
    torch.cuda.synchronize()
    launches = {"fwd": spec.launches(spec.fwd),
                "bwd": spec.launches(spec.bwd)}     # the main path ends
    check_only(spec)
    events = [start] + [e for _, e in ends]
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    out = {"steps": len(ends), "stop": stop,
           "losses": [float(m["loss"]) for m, _ in ends],
           "ok": [bool(m["ok"]) for m, _ in ends], "step_ms": step_ms,
           "median_step_ms_after_first": float(np.median(step_ms[1:])),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    del trainer, state
    torch.cuda.empty_cache()
    return out


def remat_gradients(spec: ModelSpec, policy: str, weights: dict, feed,
                    deterministic: bool = True):
    """Loss and gradients (on the host) of one f32 micro-batch under
    ``policy``, dropout on (seed 7), through the kernels; with
    ``deterministic``, under ``torch.use_deterministic_algorithms`` (the
    embedding backward's sums are otherwise summed in a varying order)."""
    from tgt_torch.models.heads import DistanceModel

    scheme = training_scheme(spec, remat_policy=policy)
    model = DistanceModel(scheme.model_cfg.replace(compute_dtype="float32"),
                          device="cuda")
    model.load_state_dict(weights)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        loss, _ = scheme.loss_fn(model, feed, seed=7)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    finally:
        torch.use_deterministic_algorithms(before, warn_only=True)
    return loss.detach().cpu(), {k: g.cpu() for k, g in zip(names, grads)}


def grad_diff(got, ref):
    """(worst |diff| / max|ref| over the gradients, that gradient's name,
    bitwise equal) of two (loss, gradients) pairs."""
    worst, worst_of = 0.0, None
    bitwise = torch.equal(got[0], ref[0])
    for k, r in ref[1].items():
        scale = float(r.abs().max())
        err = float((got[1][k] - r).abs().max())
        rel = err / scale if scale > 0 else err
        if rel > worst:
            worst, worst_of = rel, k
        bitwise &= torch.equal(got[1][k], r)
    return worst, worst_of, bitwise


def remat_policy_phase(card, spec: ModelSpec):
    """Phase 4r: each remat policy trains the flagship config at full width
    and depth (``REMAT_STEPS`` steps of b=32, N up to 48, bf16) from the
    same weights, in two passes over the policies (the second in reverse
    order: the host's noise shows between them): ms per step, peak memory,
    launches (``tri_va``: the replay launches no forward kernel; the others
    replay the 23 inner layers). Then one f32 micro-batch per policy, under
    deterministic algorithms, whose loss and gradients must equal
    ``none``'s to ``REMAT_GRAD_TOL`` of each gradient's max|ref| (and are
    expected bitwise equal); ``none`` also runs once without them, which
    shows how far two runs differ there. Returns {policy: launches}."""
    from tgt_torch.models import make_model
    from tgt_torch.ops.remat import REMAT_POLICIES

    scheme = training_scheme(spec)
    weights = make_model("distance", scheme.model_cfg, device="cuda",
                         seed=0).state_dict()
    host = next(iter(scheme.train_loader(1, 0, 1)))
    host = {k: v[:scheme.cfg.batch_size] for k, v in host.items()}
    feed = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in scheme.device_batch(host).items()}
    raw = load_config(spec)
    per_micro = spec.per_forward(raw)
    replay = per_micro - spec.per_layer_applied(raw)
    passes = {policy: [] for policy in REMAT_POLICIES}
    for order in (REMAT_POLICIES, REMAT_POLICIES[::-1]):
        for policy in order:
            passes[policy].append(remat_step(spec, policy, weights))
    ref = remat_gradients(spec, "none", weights, feed)
    noise = grad_diff(remat_gradients(spec, "none", weights, feed, False),
                      ref)
    launches = {}
    for policy in REMAT_POLICIES:
        # only tri_va's saved kernel output spares the replay its launches
        expect = {"fwd": REMAT_STEPS * (per_micro + (
                      0 if policy == "tri_va" else replay)),
                  "bwd": REMAT_STEPS * per_micro}
        got = remat_gradients(spec, policy, weights, feed)
        worst, worst_of, bitwise = grad_diff(got, ref)
        runs = passes[policy]
        row = {"policy": policy, "path": spec.name, "card": card,
               "steps": [r["steps"] for r in runs],
               "step_ms": [r["step_ms"] for r in runs],
               "median_step_ms_after_first": [
                   r["median_step_ms_after_first"] for r in runs],
               "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
               "losses": runs[0]["losses"],
               "launches": [r["launches"] for r in runs],
               "expected_launches": expect,
               "names_nothing_on_kernel_path": policy == "tri_a",
               "f32_loss": float(got[0]), "f32_loss_none": float(ref[0]),
               "f32_worst_grad_err_over_max_ref": worst,
               "f32_worst_grad": worst_of,
               "f32_bitwise_equal_to_none": bitwise}
        if policy == "none":
            row.update(f32_nondeterministic_none_worst=noise[0],
                       f32_nondeterministic_none_worst_grad=noise[1],
                       f32_nondeterministic_none_bitwise=noise[2])
        emit(row)
        for r in runs:
            if r["steps"] != REMAT_STEPS or r["stop"] is not None or \
                    not all(r["ok"]) or not all(map(math.isfinite,
                                                    r["losses"])):
                fail(f"remat_policy {policy} did not train: {r}")
            if r["launches"] != expect:
                fail(f"remat_policy {policy}: launches {r['launches']}, "
                     f"expected {expect}")
        if not worst <= REMAT_GRAD_TOL or abs(float(got[0]) - float(
                ref[0])) > REMAT_GRAD_TOL * abs(float(ref[0])):
            fail(f"remat_policy {policy}: f32 loss or gradients differ from "
                 f"none's: {row}")
        launches[policy] = {k: sum(r["launches"][k] for r in runs)
                            for k in ("fwd", "bwd")}
    return launches


# layers of the IndivConfig model: attention in the even layers, aggregate
# in the odd ones, and every fourth layer without a triplet sub-layer
INDIV_TYPES = tuple("attention" if i % 2 == 0 else "aggregate"
                    for i in range(24))
INDIV_HEADS = tuple(0 if i % 4 == 3 else 16 for i in range(24))


def indiv_serving_phase(card, spec: ModelSpec):
    """Phase 4r's IndivConfig model: the flagship config at full width and
    depth with per-layer ``triplet_type`` and ``triplet_heads``
    (``INDIV_TYPES``, ``INDIV_HEADS``), ``use_pallas: dense``, one served
    forward of 16 molecules at N=48 (bf16, one MC draw): each kernel
    launched twice per layer that carries it, every aggregate launch
    through its body. Returns {kernel: launches}."""
    from tgt_torch.models import make_model
    from tgt_torch.ops.kernels import triplet_aggregate as ta
    from tgt_torch.ops.kernels import triplet_dense as td
    from tgt_torch.schemes import get_scheme
    from tgt_torch.serving import DistancePredictor

    raw = load_config(spec, triplet_type=list(INDIV_TYPES),
                      triplet_heads=list(INDIV_HEADS), use_pallas="dense")
    scheme = get_scheme(raw["scheme"])(raw, command="evaluate")
    cfg = scheme.model_cfg
    if not cfg.has_indiv:
        fail("the per-layer lists did not reach the model config")
    model = make_model("distance", cfg, device="cuda", seed=0)
    pred = DistancePredictor(model, cfg, mc_samples=1, batch_size=16,
                             buckets=tuple(scheme.cfg.buckets), seed=0,
                             device="cuda")
    rs = np.random.RandomState(5)
    mols = [random_molecule(rs, int(n)) for n in rs.randint(41, 49, size=16)]
    pred.predict(mols)                      # warm-up
    torch.cuda.synchronize()
    reset_counts()                          # the main path starts
    probs = pred.predict(mols)
    torch.cuda.synchronize()
    launches = {"triplet_dense_fwd": td.triplet_dense_fwd.launches,
                "triplet_aggregate_fwd": ta.triplet_aggregate_fwd.launches,
                "triplet_aggregate_fwd_body":
                    ta.triplet_aggregate_fwd.body_launches}
    expect = {
        "triplet_dense_fwd": 2 * sum(
            t == "attention" and h > 0
            for t, h in zip(INDIV_TYPES, INDIV_HEADS)),
        "triplet_aggregate_fwd": 2 * sum(
            t == "aggregate" and h > 0
            for t, h in zip(INDIV_TYPES, INDIV_HEADS))}
    expect["triplet_aggregate_fwd_body"] = expect["triplet_aggregate_fwd"]
    others = {f"{w.__name__}.{a}": getattr(w, a)
              for w, a in kernel_counters() if getattr(w, a)
              and (w.__name__, a) not in (
                  ("triplet_dense_fwd", "launches"),
                  ("triplet_aggregate_fwd", "launches"),
                  ("triplet_aggregate_fwd", "body_launches"))}
    n_params = sum(p.numel() for p in model.parameters())
    row = {"indiv_config": "DistancePredictor.predict", "card": card,
           "model": os.path.relpath(spec.yaml, REPO), "params": n_params,
           "triplet_type": list(INDIV_TYPES),
           "triplet_heads": list(INDIV_HEADS), "molecules": len(mols),
           "launches": launches, "expected_launches": expect,
           "other_launches": others}
    emit(row)
    if launches != expect or others:
        fail(f"IndivConfig forward launches {launches}, expected {expect}; "
             f"others {others}")
    if probs.shape[0] != 16 or not np.isfinite(probs).all():
        fail(f"IndivConfig forward: probabilities {probs.shape}")
    return launches


# -- phase 7: the CLI -------------------------------------------------------------

CLI_MOLECULES, CLI_MAX_NODES = 256, 48
FAULT_SCALE = 0.9   # the planted fault of the f32 path-level check


@contextlib.contextmanager
def recorded_trainer():
    """Record, for every ``Trainer`` the CLI makes, a CUDA event at the end
    of each training step, the wall seconds and molecules of each
    evaluation pass and the wall seconds of each checkpoint write and
    load; count the calls of the triplet layers' plain cores (attention
    and aggregate)."""
    import tgt_torch.ops.triplet as tri
    from tgt_torch.training import Trainer

    rec = {"steps": [], "evals": [], "plain_core": 0, "checkpoint_s": [],
           "load_or_init_s": []}
    train_step, eval_epoch = Trainer.train_step, Trainer.eval_epoch
    plain = {name: getattr(tri, name)
             for name in ("_plain_core", "triplet_aggregate_fwd_reference")}
    checkpoint, load_or_init = Trainer.checkpoint, Trainer.load_or_init

    def timed(fn, key):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec[key].append(time.perf_counter() - t0)
            return out
        return call

    def step(self, *args, **kwargs):
        state, metrics = train_step(self, *args, **kwargs)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        rec["steps"].append((self.epoch, metrics, end))
        return state, metrics

    def evaluate(self, model, loader, seed=0):
        t0 = time.perf_counter()
        preds = eval_epoch(self, model, loader, seed)
        molecules = next(len(v) for k, v in preds.items()
                         if k != "valid_samples")
        rec["evals"].append((time.perf_counter() - t0, molecules))
        return preds

    def counted(core):
        def plain_core(*args, **kwargs):
            rec["plain_core"] += 1
            return core(*args, **kwargs)
        return plain_core

    Trainer.train_step, Trainer.eval_epoch = step, evaluate
    Trainer.checkpoint = timed(checkpoint, "checkpoint_s")
    Trainer.load_or_init = timed(load_or_init, "load_or_init_s")
    for name, core in plain.items():
        setattr(tri, name, counted(core))
    try:
        yield rec
    finally:
        Trainer.train_step, Trainer.eval_epoch = train_step, eval_epoch
        Trainer.checkpoint, Trainer.load_or_init = checkpoint, load_or_init
        for name, core in plain.items():
            setattr(tri, name, core)


@contextlib.contextmanager
def scaled_core(spec: ModelSpec, factor):
    """A planted fault: the path's kernel core (``spec.core``: the dense
    attention pair of TripletAttention, or TripletAggregate's aggregate
    pair) with its output scaled by ``factor`` (None leaves it as it
    is)."""
    import tgt_torch.ops.triplet as tri

    saved = getattr(tri, spec.core)
    if factor is not None:
        setattr(tri, spec.core, lambda *a, **k: saved(*a, **k) * factor)
    try:
        yield
    finally:
        setattr(tri, spec.core, saved)


def f32_eval_outputs(spec: ModelSpec, cfg: dict, model_dir: str):
    """Deterministic f32 outputs of the first val batch (``batch_size *
    prediction_bmult`` rows) from the model dir's checkpoint: through the
    kernel, through the plain path, and through the kernel scaled by
    ``FAULT_SCALE``; with each forward's kernel launches. The distance
    model gives its logits; the gap model its gaps, on bins sample 0, and
    the edge stream after its last triplet sub-layer (the output of the
    last application of layer H-2, read by a forward hook: the gap sees
    the triplet layers only through the attention's edge bias and a mean
    over nodes). Returns ({route: output}, {route: edge stream} or {},
    launches)."""
    from tgt_torch.models import make_model
    from tgt_torch.models.convert import (load_jax_npz,
                                          state_dict_from_jax_params)
    from tgt_torch.schemes import get_scheme

    scheme = get_scheme(cfg["scheme"])(dict(
        cfg, mixed_precision=False, predict_in_train=False),
        command="evaluate")
    host = next(iter(scheme.val_loader(0, 1)))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in scheme.device_batch(host, training=False).items()}
    edge_mask = scheme.edge_mask_of(batch)
    if scheme.MODEL == "gap":
        feed = scheme._feed_from_bins(batch, edge_mask,
                                      batch["dist_bins"][:, 0])
    else:
        feed = scheme._model_inputs(batch, edge_mask, None, training=False)
    state = state_dict_from_jax_params(load_jax_npz(os.path.join(
        model_dir, "checkpoint", "model.npz")), scheme.model_cfg)
    out, edge, launched = {}, {}, []
    for route, use_pallas, factor in (("dense", "dense", None),
                                      ("plain", False, None),
                                      ("fault", "dense", FAULT_SCALE)):
        model = make_model(scheme.MODEL, scheme.model_cfg.replace(
            use_pallas=use_pallas), device="cuda")
        model.load_state_dict(state)
        hook = None
        if scheme.MODEL == "gap":
            hook = model.encoder.TGT_layers[-2].register_forward_hook(
                lambda mod, args, g, route=route: edge.__setitem__(
                    route, g.e.float()))
        reset_counts()
        with torch.inference_mode(), scaled_core(spec, factor):
            out[route] = model(feed, deterministic=True).float()
        torch.cuda.synchronize()
        launched.append(spec.launches(spec.fwd))
        if not bool(torch.isfinite(out[route]).all()):
            fail(f"non-finite f32 eval outputs through the {route} path")
        if hook is not None:
            hook.remove()
        del model
    return out, edge, launched


def f32_evaluate(spec: ModelSpec, cfg: dict, samples: int):
    """The evaluate command in f32 with ``predict_in_train: false`` and
    ``samples`` draws through the kernel, the plain path and the planted
    fault: {route: (val loss, kernel launches)}."""
    from tgt_torch.cli.execute import execute

    out = {}
    for route in ("dense", "plain", "fault"):
        reset_counts()
        with scaled_core(spec, FAULT_SCALE if route == "fault" else None):
            metrics = execute("evaluate", dict(
                cfg, mixed_precision=False, predict_in_train=False,
                evaluation_samples=samples,
                use_pallas=False if route == "plain" else "dense"))
        out[route] = (metrics["val"]["loss"], spec.launches(spec.fwd))
    return out


@contextlib.contextmanager
def cli_workdir():
    """A temporary directory for phases 7 and 7b, removed after both."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_bodies(spec: ModelSpec, launched: dict, where: str) -> dict:
    """Every bf16 launch of the path took its tensor-core body, where the
    path counts them; returns the body counts."""
    bodies = spec.body_counts()
    for key, n in bodies.items():
        if n != launched[key.split("_")[0]]:
            fail(f"{where}: {n} of {launched[key.split('_')[0]]} "
                 f"{key.split('_')[0]} launches took the body")
    return bodies


def cli_phase(card, spec: ModelSpec, root: str):
    """The published config through the port's CLI on PCQM-format parquet
    under ``root`` (written by the first call): train one epoch, resume for
    a second, evaluate, predict, serve from the model dir; every command's
    triplet launches against the count its micro-batches and draws imply;
    an f32 evaluate through the kernel against the plain path."""
    import yaml

    from tgt_torch.cli.execute import execute
    from tgt_torch.data.pcqm import Bins, PCQM4Mv2Dataset
    from tgt_torch.data.prepare import write_synthetic_dataset
    from tgt_torch.serving import DistancePredictor

    data = os.path.join(root, "data")
    if not os.path.exists(os.path.join(data, "splits.npz")):
        write_synthetic_dataset(data, num_samples=CLI_MOLECULES,
                                max_nodes=CLI_MAX_NODES)
    with np.load(os.path.join(data, "splits.npz")) as splits:
        n_split = {k: len(splits[k]) for k in splits.files}
    if (n_split["train-3d"], n_split["valid-3d"], n_split["valid"]) != \
            (168, 24, 64):
        fail(f"synthetic splits {n_split}")
    cfg = load_config(spec, dataset_path=data, global_batch_size=64,
                      save_path_prefix=os.path.join(root, "models"),
                      num_epochs=1)
    model_dir = os.path.join(root, "models", cfg["model_prefix"],
                             cfg["model_name"])
    per_fwd = spec.per_forward(cfg)            # both directions
    replay = per_fwd - spec.per_layer_applied(cfg)   # remat: inner layers
    eval_b = cfg["batch_size"] * cfg["prediction_bmult"]
    steps = math.ceil(n_split["train-3d"] / cfg["global_batch_size"])
    micro = steps * cfg["global_batch_size"] // cfg["batch_size"]
    val_fwd = (math.ceil(n_split["valid-3d"] / eval_b)
               * cfg["evaluation_samples"] * per_fwd)
    epoch = {"fwd": micro * (per_fwd + replay) + val_fwd,
             "bwd": micro * per_fwd}
    expect = {
        "train": epoch, "resume": epoch,
        "evaluate": {"fwd": val_fwd, "bwd": 0},
        "predict": {"fwd": sum(math.ceil(n_split[s] / eval_b)
                               for s in ("train", "valid"))
                    * cfg["prediction_samples"] * per_fwd, "bwd": 0}}
    wall, launches, out, bodies = {}, {}, {}, {}
    with recorded_trainer() as rec:
        for name, command, extra in (
                ("train", "train", {}), ("resume", "train",
                                         {"num_epochs": 2}),
                ("evaluate", "evaluate", {}),
                ("predict", "predict", {})):
            torch.cuda.synchronize()
            reset_counts()                  # the main path starts
            t0 = time.time()
            out[name] = execute(command, dict(cfg, **extra))
            torch.cuda.synchronize()
            wall[name] = time.time() - t0
            launches[name] = {"fwd": spec.launches(spec.fwd),
                              "bwd": spec.launches(spec.bwd)}
            bodies[name] = check_bodies(spec, launches[name], name)
            check_only(spec)                # the main path ends
            if isinstance(out[name], dict):
                out[name].pop("state", None)   # free the card
            torch.cuda.empty_cache()
    if launches != expect or rec["plain_core"]:
        fail(f"CLI kernel launches {launches}, expected {expect}; "
             f"{rec['plain_core']} plain-core calls")

    # train and resume: counters, history, finite losses
    with open(os.path.join(model_dir, "checkpoint",
                           "training_state.json")) as f:
        counters = json.load(f)
    with open(os.path.join(model_dir, "logs", "history.yaml")) as f:
        history = yaml.safe_load(f)
    if (counters["epoch"], counters["global_step"]) != (2, 2 * steps) or \
            [h["global_step"] for h in history] != [steps, 2 * steps]:
        fail(f"after resume: counters {counters}, history {history}")
    if not all(math.isfinite(h["val_loss"]) and math.isfinite(h["loss"])
               for h in history):
        fail(f"non-finite training or validation loss: {history}")
    if not all(bool(m["ok"]) for _, m, _ in rec["steps"]):
        fail("a training step was skipped as non-finite")
    step_ms = {}
    for e in (0, 1):
        ends = [ev for ep, _, ev in rec["steps"] if ep == e]
        step_ms[e] = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]

    # evaluate and predict: results.yaml and the bins parquet
    with open(os.path.join(model_dir, "predictions",
                           "results.yaml")) as f:
        results = yaml.safe_load(f)
    if not math.isfinite(results["val"]["loss"]):
        fail(f"results.yaml {results}")
    eval_s, eval_mols = rec["evals"][-1]
    bins_dir = os.path.join(model_dir, "predictions",
                            f"bins{cfg['prediction_samples']}")
    for split in ("train", "valid"):
        ds = PCQM4Mv2Dataset(split, data, return_idx=True,
                             additional_columns=[Bins(
                                 bins_dir, cfg["prediction_samples"])])
        for i in range(len(ds)):
            row = ds[i]
            n = row["num_nodes"]
            b = row["dist_bins"]
            if b.shape != (cfg["prediction_samples"], n, n) or \
                    b.max() >= cfg["num_dist_bins"]:
                fail(f"{split} row {i}: bins {b.shape} max {b.max()}")

    # serve one request from the model dir
    reset_counts()
    pred = DistancePredictor.from_model_dir(
        model_dir, mc_samples=cfg["evaluation_samples"], batch_size=16,
        buckets=tuple(cfg["buckets"]))
    probs = pred.predict(request(np.random.RandomState(7), 16))
    served = spec.launches(spec.fwd)
    if served != per_fwd * cfg["evaluation_samples"] or \
            not np.isfinite(probs).all():
        fail(f"serving from the model dir: {served} launches")
    bodies["served"] = check_bodies(spec, {"fwd": served, "bwd": 0},
                                    "served")
    del pred

    # f32, deterministic: the evaluate command through the kernel,
    # through the plain path and through the kernel with a planted fault
    # (its output scaled by 0.9), on the same checkpoint; then the logits
    # of the first eval batch the same three ways. The fault must fail
    # the logits check: that shows the check can see a wrong kernel.
    f32 = f32_evaluate(spec, cfg, 2)
    (loss, n_kernel), (ref, n_plain) = f32["dense"], f32["plain"]
    rel = abs(loss - ref) / abs(ref)
    rel_fault = abs(f32["fault"][0] - ref) / abs(ref)
    logits, _, n_logits = f32_eval_outputs(spec, cfg, model_dir)
    scale = float(logits["plain"].abs().max())
    err = float((logits["dense"] - logits["plain"]).abs().max())
    err_fault = float((logits["fault"] - logits["plain"]).abs().max())
    row = {"cli": "tgt_torch.cli.execute", "path": spec.name,
           "model": os.path.relpath(spec.yaml, REPO), "card": card,
           "molecules": n_split, "wall_s": wall,
           "ms_per_step": {f"epoch_{e + 1}": v
                           for e, v in step_ms.items()},
           "median_ms_per_step_epoch_2": float(np.median(step_ms[1])),
           "molecules_per_s_evaluated": eval_mols / eval_s,
           "evaluate_s": eval_s, "evaluated_molecules": eval_mols,
           "checkpoint_s": rec["checkpoint_s"],
           "load_or_init_s": rec["load_or_init_s"],
           "history": history, "results": results,
           "launches": launches, "expected_launches": expect,
           "body_launches": bodies, "served_launches": served,
           "val_loss_f32_kernel": loss, "val_loss_f32_plain": ref,
           "val_loss_rel_diff": rel, "f32_launches": [n_kernel, n_plain],
           "val_loss_f32_fault": f32["fault"][0],
           "val_loss_rel_diff_fault": rel_fault,
           "fault_scale": FAULT_SCALE,
           "logits_f32_b": int(logits["plain"].shape[0]),
           "logits_f32_max_abs_err": err,
           "logits_f32_max_abs_err_fault": err_fault,
           "logits_f32_max_abs_ref": scale,
           "logits_f32_launches": n_logits}
    emit(row)
    if rel > 1e-4 or n_kernel != 2 * per_fwd * math.ceil(
            n_split["valid-3d"] / eval_b) or n_plain != 0:
        fail(f"f32 evaluate: kernel {loss} ({n_kernel} launches) "
             f"against plain {ref} ({n_plain})")
    if err > 1e-4 * scale or n_logits != [per_fwd, 0, per_fwd]:
        fail(f"f32 eval logits: kernel against plain max|diff| {err}, "
             f"max|ref| {scale}; launches {n_logits}")
    if err_fault <= 1e-4 * scale:
        fail(f"the logits check does not see a kernel scaled by "
             f"{FAULT_SCALE}: max|diff| {err_fault}, max|ref| {scale}")
    print(f"CLI ({spec.name}) on {card}: wall {wall}; "
          f"{row['median_ms_per_step_epoch_2']:.1f} ms per step, "
          f"{row['molecules_per_s_evaluated']:.1f} molecules/s "
          f"evaluated; f32 val loss {loss} against {ref}, with the "
          f"planted fault {f32['fault'][0]}; f32 logits max|diff| {err} "
          f"of max|ref| {scale}, with the fault {err_fault}", flush=True)
    total = {k: sum(v[k] for v in launches.values())
             for k in ("fwd", "bwd")}
    total["fwd"] += served + n_kernel
    for key in spec.body_counts():      # the f32 checks take no body
        total[key] = sum(b[key] for b in bodies.values())
    return total



# -- phase 7b: stage 2 of the published pipeline through the CLI -----------------

SERVE_BATCH = 16    # the two-stage request's device batch, as phase 3's


def size_group_permutation(mols) -> list:
    """A permutation of ``mols`` that keeps each size's molecules in their
    order and reverses the order of the sizes: the predictor's stable size
    sort gives the same device batches, so with the same seeds the same
    molecule gets the same gap wherever it stands in the request."""
    sizes = [m["num_nodes"] for m in mols]
    return [i for n in sorted(set(sizes), reverse=True)
            for i, s in enumerate(sizes) if s == n]


def stage2_phase(card, spec: ModelSpec, root: str):
    """Stage 2 of the published pipeline through the port's CLI on phase
    7's data, distance model and bins50 under ``root``: pretrain, finetune,
    gap_pred's trim and evaluate, then requests through
    ``TwoStagePredictor.from_model_dirs``; every command's and request's
    triplet launches against the count its micro-batches and draws imply;
    an f32 evaluate of the gap_pred dir through the kernel against the
    plain path, with the planted fault."""
    import yaml

    from tgt_torch.cli.execute import execute
    from tgt_torch.core.config import load_yaml
    from tgt_torch.models.convert import load_jax_npz
    from tgt_torch.serving import TwoStagePredictor

    data, models = os.path.join(root, "data"), os.path.join(root, "models")
    dist = load_config(spec)
    dist_dir = os.path.join(models, dist["model_prefix"], dist["model_name"])
    bins_dir = os.path.join(dist_dir, "predictions",
                            f"bins{dist['prediction_samples']}")
    with np.load(os.path.join(data, "splits.npz")) as splits:
        n_split = {k: len(splits[k]) for k in splits.files}

    def stage(name, **extra):
        cfg = load_yaml(spec.stage2[name])
        cfg.update(spec.overrides)
        cfg.update(dataset_path=data, save_path_prefix=models, **extra)
        return cfg, os.path.join(models, cfg["model_prefix"],
                                 cfg["model_name"])

    pt, pt_dir = stage("pretrain", global_batch_size=64, num_epochs=1)
    ft, ft_dir = stage("finetune", global_batch_size=64, num_epochs=1,
                       bins_input_path=bins_dir,
                       pretrained_weights_file=os.path.join(
                           pt_dir, "checkpoint", "model.npz"))
    gp, gp_dir = stage("gap_pred", bins_input_path=bins_dir,
                       pretrained_weights_file=os.path.join(
                           ft_dir, "checkpoint", "model.npz"))

    # the launches each command implies: the multi model runs the triplet
    # core in all its layers, the gap model in all but the last
    multi_fwd = spec.per_forward(pt)
    gap_fwd = multi_fwd - spec.per_layer_applied(pt)
    replay = gap_fwd                            # remat of the inner layers
    eval_b = pt["batch_size"] * pt["prediction_bmult"]
    val_batches = math.ceil(n_split["valid"] / eval_b)

    def trained(cfg, split, val_split):
        steps = math.ceil(n_split[split] / cfg["global_batch_size"])
        micro = steps * cfg["global_batch_size"] // cfg["batch_size"]
        val = 0
        if 1 % cfg.get("validation_frequency", 1) == 0:   # after epoch 1
            val = (math.ceil(n_split[val_split] / eval_b)
                   * cfg["evaluation_samples"] * multi_fwd)
        return {"fwd": micro * (multi_fwd + replay) + val,
                "bwd": micro * multi_fwd}

    mc = gp["evaluation_samples"]
    expect = {"pretrain": trained(pt, "train-3d", "valid-3d"),
              "finetune": trained(ft, "train", "valid"),
              "gap_pred": {"fwd": 0, "bwd": 0},
              "evaluate": {"fwd": val_batches * mc * gap_fwd, "bwd": 0}}
    wall, launches, steps_of, bodies = {}, {}, {}, {}
    with recorded_trainer() as rec:
        for name, command, cfg in (("pretrain", "train", pt),
                                   ("finetune", "train", ft),
                                   ("gap_pred", "train", gp),
                                   ("evaluate", "evaluate", gp)):
            first = len(rec["steps"])
            torch.cuda.synchronize()
            reset_counts()                      # the main path starts
            t0 = time.time()
            out = execute(command, cfg)
            torch.cuda.synchronize()
            wall[name] = time.time() - t0
            launches[name] = {"fwd": spec.launches(spec.fwd),
                              "bwd": spec.launches(spec.bwd)}
            bodies[name] = check_bodies(spec, launches[name], name)
            check_only(spec)                    # the main path ends
            steps_of[name] = rec["steps"][first:]
            del out
            torch.cuda.empty_cache()
    if launches != expect or rec["plain_core"]:
        fail(f"stage-2 kernel launches {launches}, expected {expect}; "
             f"{rec['plain_core']} plain-core calls")

    # pretrain and finetune: finite losses, every step applied
    histories = {}
    for name, d in (("pretrain", pt_dir), ("finetune", ft_dir)):
        with open(os.path.join(d, "logs", "history.yaml")) as f:
            histories[name] = yaml.safe_load(f)
        losses = [float(m["loss"]) for _, m, _ in steps_of[name]]
        if not steps_of[name] or not all(
                bool(m["ok"]) for _, m, _ in steps_of[name]) or \
                not all(math.isfinite(x) for x in losses):
            fail(f"{name}: a non-finite or skipped step: {losses}")
        if len(histories[name]) != 1 or not all(
                math.isfinite(v) for k, v in histories[name][0].items()
                if k.endswith("loss")):
            fail(f"{name} history {histories[name]}")
    if "val_loss" not in histories["finetune"][0]:
        fail("finetune did not validate")
    ends = [ev for _, _, ev in steps_of["finetune"]]
    ft_step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]

    # gap_pred: the trimmed checkpoint and results.yaml
    if sorted(os.listdir(os.path.join(gp_dir, "checkpoint"))) != \
            ["model.npz"]:
        fail("gap_pred's train did not write the trimmed checkpoint alone")
    trimmed = load_jax_npz(os.path.join(gp_dir, "checkpoint", "model.npz"))
    if "pred" not in trimmed or "dist_pred" in trimmed or \
            "tria" in trimmed["encoder"]["last"]:
        fail(f"trimmed checkpoint keys {sorted(trimmed)}")
    with open(os.path.join(gp_dir, "predictions", "results.yaml")) as f:
        results = yaml.safe_load(f)
    if not math.isfinite(results["val"]["loss"]):
        fail(f"gap_pred results.yaml {results}")
    eval_s, eval_mols = rec["evals"][-1]

    # the two-stage request: molecules in, gaps out, on the card
    two = TwoStagePredictor.from_model_dirs(
        dist_dir, gp_dir, mc_samples=mc, batch_size=SERVE_BATCH,
        buckets=tuple(gp["buckets"]))
    rs = np.random.RandomState(11)
    two.predict(request(rs, SERVE_BATCH))      # warm-up
    first = request(rs)
    perm = size_group_permutation(first)
    requests = [("first", first, True),
                ("first, sizes reversed", [first[i] for i in perm], True),
                ("second", request(rs), False)]
    n_batches = math.ceil(len(first) / SERVE_BATCH)
    per_request = n_batches * mc * (multi_fwd + gap_fwd)
    torch.cuda.synchronize()
    reset_counts()                              # the main path starts
    lat, gaps = [], []
    for name, mols, reseed in requests:
        if reseed:                              # the same draws' seeds
            two.distance._seeds.manual_seed(1)
            two.gap._seeds.manual_seed(2)
        before = spec.launches(spec.fwd)
        t0 = time.perf_counter()
        out = two.predict(mols)
        lat.append(time.perf_counter() - t0)
        launched = spec.launches(spec.fwd) - before
        if launched != per_request:
            fail(f"two-stage request {name}: {launched} kernel launches, "
                 f"expected {per_request}")
        if out.shape != (len(mols),) or not np.isfinite(out).all():
            fail(f"two-stage request {name}: gaps {out.shape}")
        gaps.append(out)
    served = spec.launches(spec.fwd)            # the main path ends
    bodies["two_stage"] = check_bodies(spec, {"fwd": served, "bwd": 0},
                                       "two-stage")
    check_only(spec)
    order_err = float(np.abs(gaps[1] - gaps[0][perm]).max())
    if order_err > 1e-5 * float(np.abs(gaps[0]).max()):
        fail(f"two-stage gaps out of input order: max|diff| {order_err}")
    del two

    # f32, deterministic: the gap_pred dir's evaluate through the kernel,
    # the plain path and the planted fault; then the gaps of the first eval
    # batch the same three ways, which the fault must fail
    f32 = f32_evaluate(spec, gp, 2)
    (mae, n_kernel), (ref, n_plain) = f32["dense"], f32["plain"]
    rel = abs(mae - ref) / abs(ref)
    gap32, edge32, n_gap32 = f32_eval_outputs(spec, gp, gp_dir)
    scale = float(gap32["plain"].abs().max())
    err = float((gap32["dense"] - gap32["plain"]).abs().max())
    err_fault = float((gap32["fault"] - gap32["plain"]).abs().max())
    # the closer check: the edge stream after the last triplet sub-layer
    e_scale = float(edge32["plain"].abs().max())
    e_err = float((edge32["dense"] - edge32["plain"]).abs().max())
    e_err_fault = float((edge32["fault"] - edge32["plain"]).abs().max())
    p50 = float(np.median(lat))
    row = {"stage2": "tgt_torch.cli.execute + TwoStagePredictor",
           "path": spec.name,
           "models": {k: os.path.relpath(v, REPO)
                      for k, v in spec.stage2.items()},
           "card": card, "molecules": n_split, "wall_s": wall,
           "ms_per_finetune_step": ft_step_ms,
           "median_ms_per_finetune_step": float(np.median(ft_step_ms)),
           "step_ms": {k: [a.elapsed_time(b) for a, b in zip(
               [e for _, _, e in v], [e for _, _, e in v][1:])]
               for k, v in steps_of.items() if v},
           "evaluate_s": eval_s, "evaluated_molecules": eval_mols,
           "molecules_per_s_evaluated": eval_mols / eval_s,
           "checkpoint_s": rec["checkpoint_s"],
           "load_or_init_s": rec["load_or_init_s"],
           "history": histories, "results": results,
           "launches": launches, "expected_launches": expect,
           "body_launches": bodies,
           "two_stage_request_s": lat, "two_stage_p50_s": p50,
           "two_stage_molecules_per_s": len(first) / p50,
           "two_stage_launches": served,
           "two_stage_launches_per_request": per_request,
           "two_stage_order_max_abs_diff": order_err,
           "gap_mae_f32_kernel": mae, "gap_mae_f32_plain": ref,
           "gap_mae_rel_diff": rel, "f32_launches": [n_kernel, n_plain],
           "gap_mae_f32_fault": f32["fault"][0],
           "gaps_f32_b": int(gap32["plain"].shape[0]),
           "gaps_f32_max_abs_err": err,
           "gaps_f32_max_abs_err_fault": err_fault,
           "gaps_f32_max_abs_ref": scale,
           "gaps_f32_launches": n_gap32, "fault_scale": FAULT_SCALE,
           "gaps_fault_margin": err_fault / (1e-4 * scale),
           "edge_f32_max_abs_err": e_err,
           "edge_f32_max_abs_err_fault": e_err_fault,
           "edge_f32_max_abs_ref": e_scale,
           "edge_fault_margin": e_err_fault / (1e-4 * e_scale)}
    emit(row)
    if rel > 1e-4 or n_kernel != 2 * gap_fwd * val_batches or n_plain != 0:
        fail(f"f32 gap_pred evaluate: kernel {mae} ({n_kernel} launches) "
             f"against plain {ref} ({n_plain})")
    if err > 1e-4 * scale or n_gap32 != [gap_fwd, 0, gap_fwd]:
        fail(f"f32 gaps: kernel against plain max|diff| {err}, max|ref| "
             f"{scale}; launches {n_gap32}")
    if err_fault <= 1e-4 * scale:
        fail(f"the gaps check does not see a kernel scaled by "
             f"{FAULT_SCALE}: max|diff| {err_fault}, max|ref| {scale}")
    if e_err > 1e-4 * e_scale or e_err_fault <= 1e-4 * e_scale:
        fail(f"f32 edge stream after the last triplet sub-layer: kernel "
             f"against plain max|diff| {e_err}, with the fault "
             f"{e_err_fault}, max|ref| {e_scale}")
    print(f"stage 2 ({spec.name}) on {card}: pretrain "
          f"{wall['pretrain']:.1f} s, finetune "
          f"{wall['finetune']:.1f} s, trim {wall['gap_pred']:.1f} s, "
          f"evaluate {wall['evaluate']:.1f} s; "
          f"{row['median_ms_per_finetune_step']:.1f} ms per finetune step, "
          f"{row['molecules_per_s_evaluated']:.1f} molecules/s evaluated; "
          f"two-stage {row['two_stage_molecules_per_s']:.2f} molecules/s "
          f"served, p50 {p50:.2f} s; f32 MAE {mae} against {ref}, f32 "
          f"gaps max|diff| {err} of max|ref| {scale}, with the fault "
          f"{err_fault}; edge stream {e_err} of {e_scale}, with the fault "
          f"{e_err_fault}", flush=True)
    total = {k: dict(v, **bodies[k]) for k, v in launches.items()
             if k != "evaluate"}
    total["gap_pred"]["fwd"] += launches["evaluate"]["fwd"] + n_kernel
    for key, n in bodies["evaluate"].items():   # the f32 checks take none
        total["gap_pred"][key] += n
    total["two_stage"] = {"fwd": served, "bwd": 0, **bodies["two_stage"]}
    return total


# -- phase 7v: the MC-draw schedule through the CLI and the two-stage request -----

def schedule_cli_phase(card, spec: ModelSpec, root: str):
    """Phase 7v, in phase 7's directory on its distance dir and phase 7b's
    gap_pred dir: ``execute("evaluate")`` under ``mc_eval_mode`` map and
    vmap in turns, in bf16 with exact launches (per draw and eval batch
    ``per_forward`` under map, per eval batch under vmap) and in f32 (val
    losses within 1e-4 relative); three 64-molecule ``TwoStagePredictor``
    requests under ``mc_mode`` map and vmap in turns (batch 16, 10 draws
    in each stage; launches exact), and one f32 request of 16 molecules,
    vmap against map within 1e-4 of max|ref|. Returns the vmap launches by
    path, with the body counts where the path counts them."""
    from tgt_torch.cli.execute import execute
    from tgt_torch.core.config import load_yaml
    from tgt_torch.models import make_model
    from tgt_torch.serving import (DistancePredictor, GapPredictor,
                                   TwoStagePredictor)

    data, models = os.path.join(root, "data"), os.path.join(root, "models")
    cfg = load_config(spec, dataset_path=data, global_batch_size=64,
                      save_path_prefix=models, num_epochs=1)
    dist_dir = os.path.join(models, cfg["model_prefix"], cfg["model_name"])
    gp = load_yaml(spec.stage2["gap_pred"])
    gp.update(spec.overrides)
    gp_dir = os.path.join(models, gp["model_prefix"], gp["model_name"])
    with np.load(os.path.join(data, "splits.npz")) as splits:
        n_val = len(splits["valid-3d"])
    per_fwd = spec.per_forward(cfg)
    gap_fwd = spec.per_forward(gp) - spec.per_layer_applied(gp)
    mc = cfg["evaluation_samples"]
    eval_b = cfg["batch_size"] * cfg["prediction_bmult"]
    batches = math.ceil(n_val / eval_b)
    forwards = {"map": mc, "vmap": 1}       # per device batch
    out = {"evaluate_vmap": {}, "two_stage_vmap": {}}

    # the evaluate command, bf16 then f32, the order alternating
    evals = {}
    with recorded_trainer() as rec:
        for precision, extra, modes in (
                ("bf16", {}, MODES),
                ("f32", {"mixed_precision": False}, MODES[::-1])):
            for mode in modes:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                metrics = execute("evaluate", dict(
                    cfg, mc_eval_mode=mode, **extra))
                torch.cuda.synchronize()
                launched = {"fwd": spec.launches(spec.fwd), "bwd": 0}
                check_only(spec)
                expect = batches * forwards[mode] * per_fwd
                if launched["fwd"] != expect or rec["plain_core"]:
                    fail(f"evaluate ({precision}, {mode}): {launched} "
                         f"launches, expected {expect}; "
                         f"{rec['plain_core']} plain-core calls")
                check_bodies(spec, launched, f"evaluate ({precision})")
                if precision == "bf16" and mode == "vmap":
                    out["evaluate_vmap"] = {"fwd": launched["fwd"]}
                eval_s, molecules = rec["evals"][-1]
                evals[precision, mode] = {
                    "val_loss": metrics["val"]["loss"], "eval_s": eval_s,
                    "molecules_per_s": molecules / eval_s,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": launched["fwd"]}
                metrics.pop("state", None)
                torch.cuda.empty_cache()
    loss = {k: v["val_loss"] for k, v in evals.items()}
    rel = abs(loss["f32", "vmap"] - loss["f32", "map"]) / abs(loss["f32",
                                                                   "map"])
    emit({"evaluate": "mc_eval_mode map and vmap", "path": spec.name,
          "eval_batch": eval_b, "draws": mc, "card": card,
          "runs": {f"{p}_{m}": v for (p, m), v in evals.items()},
          "val_loss_f32_rel_diff": rel})
    if not all(math.isfinite(v) for v in loss.values()) or rel > 1e-4:
        fail(f"evaluate under vmap: val losses {loss}, f32 relative "
             f"difference {rel}")

    # the two-stage request
    twos = {m: TwoStagePredictor.from_model_dirs(
        dist_dir, gp_dir, mc_samples=mc, batch_size=SERVE_BATCH,
        buckets=tuple(gp["buckets"]), mc_mode=m) for m in MODES}
    rs = np.random.RandomState(13)
    warm = request(rs, SERVE_BATCH)
    for m in MODES:
        twos[m].predict(warm)                   # warm-up
    requests = [request(rs) for _ in range(3)]
    n_batches = math.ceil(len(requests[0]) / SERVE_BATCH)
    torch.cuda.synchronize()
    reset_counts()                              # the main path starts
    lat = {m: [] for m in MODES}
    launched_by = {m: 0 for m in MODES}
    for r, mols in enumerate(requests):
        for mode in (MODES if r % 2 == 0 else MODES[::-1]):
            before = spec.launches(spec.fwd)
            t0 = time.perf_counter()
            gaps = twos[mode].predict(mols)
            lat[mode].append(time.perf_counter() - t0)
            launched = spec.launches(spec.fwd) - before
            launched_by[mode] += launched
            expect = n_batches * forwards[mode] * (per_fwd + gap_fwd)
            if launched != expect:
                fail(f"two-stage request {r} ({mode}): {launched} kernel "
                     f"launches, expected {expect}")
            if gaps.shape != (len(mols),) or not np.isfinite(gaps).all():
                fail(f"two-stage request {r} ({mode}): gaps {gaps.shape}")
    check_bodies(spec, {"fwd": spec.launches(spec.fwd), "bwd": 0},
                 "two-stage")                   # the main path ends
    check_only(spec)
    out["two_stage_vmap"] = {"fwd": launched_by["vmap"]}

    # f32: the same weights, vmap against map on one request
    f32 = {}
    models32 = {}
    for stage, kind in (("distance", "distance"), ("gap", "gap")):
        src = getattr(twos["map"], stage)
        cfg32 = src.cfg.replace(compute_dtype="float32")
        model = make_model(kind, cfg32, device="cuda")
        model.load_state_dict(src.model.state_dict())
        models32[stage] = (model, cfg32)
    mols = request(rs, SERVE_BATCH)
    for m in MODES:
        kw = dict(mc_samples=mc, batch_size=SERVE_BATCH,
                  buckets=tuple(gp["buckets"]), device="cuda", mc_mode=m)
        two = TwoStagePredictor(
            DistancePredictor(*models32["distance"], seed=21, **kw),
            GapPredictor(*models32["gap"], seed=22, **kw),
            range_bins=twos["map"].range_bins)
        f32[m] = two.predict(mols)
    err = float(np.abs(f32["vmap"] - f32["map"]).max())
    scale = float(np.abs(f32["map"]).max())
    row = {"two_stage": "TwoStagePredictor.predict, mc_mode map and vmap",
           "path": spec.name, "card": card, "batch": SERVE_BATCH,
           "draws": mc, **{f"p50_request_s_{m}": float(np.median(lat[m]))
                           for m in MODES},
           **{f"molecules_per_s_{m}": 64 / float(np.median(lat[m]))
              for m in MODES},
           "request_s": lat, "launches": launched_by,
           "f32_max_abs_err": err, "f32_max_abs_ref": scale}
    emit(row)
    if err > 1e-4 * scale or not np.isfinite(f32["vmap"]).all():
        fail(f"f32 two-stage gaps under vmap against map: max|diff| {err}, "
             f"max|ref| {scale}")
    del twos, models32
    torch.cuda.empty_cache()
    return out


# -- phase 7p: the real-data runbook on a PCQM4Mv2 stand-in ---------------------

PREP_SPLITS = {"train": 192, "valid": 32, "test-dev": 32,
               "test-challenge": 8}
PREP_FALLBACK = (5, 77, 200, 230)   # embedding fails: 2D coordinates
PREP_NO_CONFS = (31,)               # MMFF returns nothing: 2D as well
PREP_DUMMY = 42                     # a leading dummy atom: zero coordinates
PREP_WITH_HS = (3, 150)             # SDF molecules with explicit hydrogens
PREP_CONFS = 4                      # conformers per molecule
# name fragments of the dense forward kernel's functions in a trace
DENSE_FWD_KERNELS = ("tfwd::", "triplet_dense_fwd_kernel")


class StandInMol:
    """An RDKit molecule's stand-in: atoms (atomic number, OGB features),
    bonds (begin, end, OGB features) and conformers by id."""

    class Atom(NamedTuple):
        z: int
        feats: list

        def GetAtomicNum(self):
            return self.z

    class Bond(NamedTuple):
        i: int
        j: int
        feats: list

        def GetBeginAtomIdx(self):
            return self.i

        def GetEndAtomIdx(self):
            return self.j

    class Conf(NamedTuple):
        coords: np.ndarray

        def GetPositions(self):
            return self.coords

    def __init__(self, key, atoms, bonds, confs):
        self.key, self.atoms, self.bonds, self.confs = key, atoms, bonds, confs

    def GetAtoms(self):
        return list(self.atoms)

    def GetBonds(self):
        return list(self.bonds)

    def GetNumAtoms(self):
        return len(self.atoms)

    def GetAtomWithIdx(self, i):
        return self.atoms[i]

    def GetConformer(self, id=0):
        return self.confs[id]

    def without_hs(self):
        """A copy without its hydrogens (all at the end), their bonds and
        their coordinate rows."""
        keep = sum(a.z != 1 for a in self.atoms)
        return StandInMol(self.key, self.atoms[:keep],
                          [b for b in self.bonds if max(b.i, b.j) < keep],
                          {c: self.Conf(v.coords[:keep])
                           for c, v in self.confs.items()})


def standin_molecules(seed: int = 0) -> list:
    """The stand-in's molecules by OGB index, from the port's synthetic
    generator, 4-48 atoms."""
    from tgt_torch.data.synthetic import make_molecule

    rs = np.random.RandomState(seed)
    return [make_molecule(rs, int(rs.randint(4, CLI_MAX_NODES + 1)))
            for _ in range(sum(PREP_SPLITS.values()))]


def standin_mol(key: int, m: dict, with_conf: bool) -> StandInMol:
    """Molecule ``m`` as an RDKit stand-in: carbon atoms (atom 0 of
    ``PREP_DUMMY`` a dummy), each bond once, its DFT coordinates as
    conformer 0; ``PREP_WITH_HS`` carry two hydrogens at the end."""
    n = m["num_nodes"]
    half = len(m["edges"]) // 2
    atoms = [StandInMol.Atom(0 if key == PREP_DUMMY and i == 0 else 6,
                             m["node_features"][i].tolist())
             for i in range(n)]
    bonds = [StandInMol.Bond(int(i), int(j), f.tolist()) for (i, j), f in
             zip(m["edges"][:half], m["edge_features"][:half])]
    coords = m["dft_coords"].astype(np.float64)
    if key in PREP_WITH_HS:
        atoms += [StandInMol.Atom(1, [0] * 9)] * 2
        bonds += [StandInMol.Bond(0, n, [0] * 3),
                  StandInMol.Bond(0, n + 1, [0] * 3)]
        coords = np.concatenate([coords, np.full((2, 3), 9.0)])
    return StandInMol(key, atoms, bonds,
                      {0: StandInMol.Conf(coords)} if with_conf else {})


def standin_conformers(key: int, n: int):
    """The stand-in's MMFF results and conformers of molecule ``key`` with
    ``n`` atoms (hydrogens included), and the one to keep: conformer 0 has
    the lowest energy but did not converge, so by tuple order the converged
    one of lowest energy wins."""
    rs = np.random.RandomState(1000 + key)
    best = key % (PREP_CONFS - 1) + 1
    results = [(1, -100.0)] + [(0, 1.0 + float(rs.rand()))
                               for _ in range(PREP_CONFS - 1)]
    results[best] = (0, 0.5)
    return results, [rs.randn(n, 3) * 1.5 for _ in range(PREP_CONFS)], best


def standin_2d(n: int) -> np.ndarray:
    return np.stack([np.arange(n), -np.arange(n), np.zeros(n)], 1) * 1.5


def standin_toolkits(mols: list):
    """Stand-ins of what the preparation takes from ogb and rdkit: the OGB
    dataset (SMILES 'mol<i>', targets hidden for test-dev and
    test-challenge), the SDF supplier of the train molecules with their DFT
    coordinates, ``smiles2graph``, ``Chem``, ``AllChem`` and
    ``ogb.utils.features``."""
    import types

    split, lo = {}, 0
    for name, k in PREP_SPLITS.items():
        split[name] = np.arange(lo, lo + k)
        lo += k
    hidden = PREP_SPLITS["train"] + PREP_SPLITS["valid"]

    class OGB:
        def get_idx_split(self):
            return split

        def __getitem__(self, i):
            return (f"mol{i}", float("nan") if i >= hidden
                    else mols[i]["target"])

    class Supplier:
        def __init__(self):
            self.mols = [standin_mol(i, mols[i], True)
                         for i in range(PREP_SPLITS["train"])]

        def __len__(self):
            return len(self.mols)

        def __getitem__(self, i):
            return self.mols[i]

        def __iter__(self):
            return iter(self.mols)

    def smiles2graph(smiles):
        m = mols[int(smiles[3:])]
        return {"num_nodes": m["num_nodes"],
                "edge_index": np.ascontiguousarray(m["edges"].T),
                "node_feat": m["node_features"].astype(np.int64),
                "edge_feat": m["edge_features"].astype(np.int64)}

    def add_hs(mol):
        return StandInMol(mol.key, mol.atoms + [StandInMol.Atom(1, [0] * 9)]
                          * 2, mol.bonds, dict(mol.confs))

    def embed(mol, numConfs, numThreads):
        if mol.key in PREP_FALLBACK:
            raise RuntimeError("embedding failed")
        _, coords, _ = standin_conformers(mol.key, mol.GetNumAtoms())
        for c in range(numConfs):
            mol.confs[c] = StandInMol.Conf(coords[c])

    def optimize(mol, numThreads):
        if mol.key in PREP_NO_CONFS:
            return []
        return standin_conformers(mol.key, mol.GetNumAtoms())[0]

    def compute_2d(mol):
        mol.confs[0] = StandInMol.Conf(standin_2d(mol.GetNumAtoms()))

    chem = types.SimpleNamespace(
        RemoveAllHs=StandInMol.without_hs, RemoveHs=StandInMol.without_hs,
        AddHs=add_hs, MolFromSmiles=lambda s: standin_mol(
            int(s[3:]), mols[int(s[3:])], False))
    allchem = types.SimpleNamespace(
        EmbedMultipleConfs=embed, MMFFOptimizeMoleculeConfs=optimize,
        Compute2DCoords=compute_2d)
    features = types.ModuleType("ogb.utils.features")
    features.atom_to_feature_vector = lambda atom: list(atom.feats)
    features.bond_to_feature_vector = lambda bond: list(bond.feats)
    return OGB(), Supplier(), smiles2graph, chem, allchem, features


@contextlib.contextmanager
def standin_modules(features):
    """The stand-in ``ogb.utils.features`` in sys.modules, for
    ``_mol2graph``, which imports it; sys.modules is restored after."""
    import types

    names = ("ogb", "ogb.utils", "ogb.utils.features")
    saved = {name: sys.modules.get(name) for name in names}
    ogb, utils = types.ModuleType("ogb"), types.ModuleType("ogb.utils")
    ogb.utils, utils.features = utils, features
    sys.modules.update(zip(names, (ogb, utils, features)))
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def standin_rdkit_coords(key: int, m: dict) -> np.ndarray:
    """The coordinates the conformer preparation must give molecule
    ``key``."""
    n = m["num_nodes"]
    if key == PREP_DUMMY:
        return np.zeros((n, 3), np.float32)
    if key in PREP_FALLBACK + PREP_NO_CONFS:
        return standin_2d(n).astype(np.float32)
    _, coords, best = standin_conformers(key, n + 2)
    return coords[best][:n].astype(np.float32)


def cpu_model() -> str:
    """The host CPU: the model name /proc/cpuinfo gives, or its vendor,
    family and model numbers, or the machine type; and the CPU count."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model",
                                     "CPU implementer", "CPU part")
        if fields.get(k)) or platform.processor() or platform.machine()
    return f"{name}, {os.cpu_count()} CPUs"


def native_transform_check(card, mols: list) -> dict:
    """The structural transform runs the native library, bitwise equal to
    its numpy version on every molecule; the median microseconds per
    molecule of each (host numbers, with the CPU model beside them)."""
    from tgt_torch.data import structural

    if structural.backend() != "native":
        fail(f"the structural transform runs {structural.backend()}")
    times = {"native": [], "numpy": []}
    for i, m in enumerate(mols):
        args = (m["num_nodes"], m["edges"], m["node_features"],
                m["edge_features"])
        out = {}
        for name, fn in (("native", structural.preprocess_graph),
                         ("numpy", structural.preprocess_graph_numpy)):
            t0 = time.perf_counter()
            out[name] = fn(*args)
            times[name].append(time.perf_counter() - t0)
        for a, b in zip(out["native"], out["numpy"]):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                fail(f"molecule {i}: the native structural transform "
                     f"differs from numpy")
    cpu = cpu_model()
    us = {k: float(np.median(v)) * 1e6 for k, v in times.items()}
    print(f"native structural transform on {cpu} (card {card}): median "
          f"{us['native']:.2f} us per molecule, numpy {us['numpy']:.2f} us, "
          f"{len(mols)} molecules, bitwise equal", flush=True)
    return {"backend": "native", "cpu": cpu, "molecules": len(mols),
            "median_us_native": us["native"], "median_us_numpy": us["numpy"],
            "bitwise_equal": True}


def prepared_rows_check(data: str, mols: list) -> None:
    """Every row read back through the port's dataset equals its source
    molecule after the structural transform, with its target and its DFT
    and RDKit coordinates."""
    from tgt_torch.data.pcqm import Coords, PCQM4Mv2Dataset
    from tgt_torch.data.structural import AddStructuralData

    hidden = PREP_SPLITS["train"] + PREP_SPLITS["valid"]
    for split, cols in (("train", ("dft", "rdkit")), ("valid", ("rdkit",)),
                        ("test-dev", ("rdkit",))):
        ds = PCQM4Mv2Dataset(split, data, return_idx=True,
                             additional_columns=[Coords(c) for c in cols],
                             transforms=[AddStructuralData()])
        if len(ds) != PREP_SPLITS[split]:
            fail(f"prepared {split}: {len(ds)} rows")
        for r in range(len(ds)):
            row = ds[r]
            i = int(row["idx"])
            m = mols[i]
            want = AddStructuralData()({k: m[k] for k in (
                "num_nodes", "edges", "node_features", "edge_features")})
            for k in ("node_features", "distance_matrix", "feature_matrix"):
                if not np.array_equal(row[k], want[k]):
                    fail(f"prepared row {i}: {k} differs from the source")
            if split == "train" and not np.array_equal(
                    row["dft_coords"], m["dft_coords"]):
                fail(f"prepared row {i}: DFT coordinates differ")
            target = row["target"]
            if (i >= hidden and not np.isnan(target)) or (
                    i < hidden and target != np.float32(m["target"])):
                fail(f"prepared row {i}: target {target}")
            if not np.array_equal(row["rdkit_coords"],
                                  standin_rdkit_coords(i, m)):
                fail(f"prepared row {i}: RDKit coordinates differ")


def converted_checkpoint_check(card, spec: ModelSpec, root: str):
    """The distance model at seed 0 saved as a reference ``model_state.pt``,
    converted by ``python -m tgt_torch.models.convert`` in a subprocess and
    served from a model dir around the ``.npz``: logits and predictions
    bitwise equal to the in-memory model's with the same seeds; then a
    served forward under ``trace()``, and ``flops_estimate`` of one.
    Returns the kernel launches and the row."""
    import shutil

    from tgt_torch.core.config import save_yaml
    from tgt_torch.models import make_model
    from tgt_torch.schemes import get_scheme
    from tgt_torch.serving import DistancePredictor
    from tgt_torch.utils.profiling import count_params, flops_estimate, trace

    raw = load_config(spec)
    scheme = get_scheme(raw["scheme"])(raw, command="evaluate")
    cfg, buckets = scheme.model_cfg, tuple(scheme.cfg.buckets)
    mc = scheme.cfg.evaluation_samples
    per_fwd = spec.per_forward(raw)
    model = make_model("distance", cfg, device="cuda", seed=0)
    n_params = count_params(model)
    model_dir = os.path.join(root, "converted")
    os.makedirs(os.path.join(model_dir, "checkpoint"))
    save_yaml(raw, os.path.join(model_dir, "config.yaml"))
    state_path = os.path.join(root, "model_state.pt")
    t0 = time.perf_counter()
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               state_path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "tgt_torch.models.convert", state_path,
         os.path.join(model_dir, "checkpoint", "model.npz"),
         "--config", spec.yaml], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    convert_s = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"python -m tgt_torch.models.convert exited {res.returncode}:"
             f"\n{res.stdout}\n{res.stderr}")
    os.remove(state_path)

    mols = request(np.random.RandomState(17), 16)
    reset_counts()
    served = DistancePredictor.from_model_dir(
        model_dir, mc_samples=mc, batch_size=SERVE_BATCH, buckets=buckets,
        seed=5)
    memory = DistancePredictor(model, cfg, mc_samples=mc,
                               batch_size=SERVE_BATCH, buckets=buckets,
                               seed=5, device="cuda")
    got = served.predict(mols)
    n_served = spec.launches(spec.fwd)
    want = memory.predict(mols)
    feed = device_batch(mols, buckets)
    with torch.inference_mode():
        reset_counts()
        logits = served.model(feed, deterministic=True)
        ref = memory.model(feed, deterministic=True)
        torch.cuda.synchronize()
        n_logits = spec.launches(spec.fwd)
        logits_equal = bool(torch.equal(logits, ref))
    if n_served != per_fwd * mc or n_logits != 2 * per_fwd:
        fail(f"converted checkpoint: {n_served} launches served, "
             f"{n_logits} for two forwards; expected {per_fwd * mc} and "
             f"{2 * per_fwd}")
    if not logits_equal or not np.array_equal(got, want):
        fail(f"the converted checkpoint's outputs differ from the "
             f"in-memory model's: logits max|diff| "
             f"{float((logits.float() - ref.float()).abs().max())}, "
             f"predictions {float(np.abs(got - want).max())}")
    del memory, model

    # one served forward at b=16, N=48 under trace(): its Chrome trace,
    # under chiprun_out/, names the dense forward kernel
    logdir = os.path.join(REPO, "chiprun_out", "trace_7p")
    shutil.rmtree(logdir, ignore_errors=True)
    rs = np.random.RandomState(19)
    feed48 = device_batch([random_molecule(rs, int(n)) for n in
                           rs.randint(41, 49, size=SERVE_BATCH)], buckets)
    reset_counts()
    with torch.inference_mode():
        with trace(logdir):
            served.model(feed48)
        flops = flops_estimate(served.model, feed48)
    n_traced = spec.launches(spec.fwd)
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    if len(files) != 1 or n_traced != 2 * per_fwd:
        fail(f"trace(): files {files}, launches {n_traced}")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    named = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                    and any(k in e["name"] for k in DENSE_FWD_KERNELS)})
    if not named:
        fail(f"the trace of a served forward names no dense forward "
             f"kernel ({len(events)} events)")
    n = int(feed48["node_mask"].shape[1])
    row = {"converted_params": n_params, "model_state_save_s": save_s,
           "convert_s": convert_s, "convert_stdout": res.stdout.strip(),
           "served_launches": n_served, "logits_bitwise_equal": True,
           "predictions_bitwise_equal": True,
           "trace_file": os.path.relpath(os.path.join(logdir, files[0]),
                                         REPO),
           "trace_events": len(events), "trace_dense_kernels": named,
           "flops_estimate": {"b": SERVE_BATCH, "n": n, **flops}}
    print(f"converted checkpoint ({n_params} parameters) on {card}: "
          f"convert {convert_s:.1f} s, served {n_served} launches, logits "
          f"and predictions bitwise equal; the trace names {named}; "
          f"flops_estimate of one forward at b={SERVE_BATCH}, N={n}: "
          f"{flops['flops']:.6g}", flush=True)
    return n_served + n_logits + n_traced, row


def prep_phase(card, spec: ModelSpec, root: str):
    """The real-data runbook on a PCQM4Mv2 stand-in under ``root``: the
    port's preparation and its read-back, the native structural transform,
    training and evaluating the published config on the prepared directory
    through the CLI, and a converted full-width checkpoint served from a
    model dir; every command's triplet launches against the count its
    micro-batches and draws imply."""
    from tgt_torch.cli.execute import execute
    from tgt_torch.data import prepare
    from tgt_torch.training import Trainer
    from tgt_torch.utils.profiling import StepTimer

    t_phase = time.time()
    data = os.path.join(root, "prep_data")
    mols = standin_molecules()
    ogb, supplier, smiles2graph, chem, allchem, features = \
        standin_toolkits(mols)
    t0 = time.time()
    with standin_modules(features):
        records, splits = prepare.build_pcqm_records(
            ogb, supplier, smiles2graph, remove_all_hs=chem.RemoveAllHs)
    prepare.write_dataset(records, data, coords_names=("dft",),
                          splits=splits)
    prepare.build_rdkit_coords(supplier, lambda: ogb, data, chem, allchem,
                               num_confs=PREP_CONFS)
    prepare_s = time.time() - t0
    n_split = {k: len(v) for k, v in splits.items()}
    t3, v3 = splits["train-3d"], splits["valid-3d"]
    if (len(t3), len(v3)) != (144, 48) or np.any(np.diff(t3) <= 0) or \
            np.any(np.diff(v3) <= 0) or not np.array_equal(
                np.sort(np.concatenate([t3, v3])), splits["train"]):
        fail(f"prepared splits {n_split}")
    challenge = set(ogb.get_idx_split()["test-challenge"].tolist())
    if len(records) != 256 or challenge & {r["idx"] for r in records}:
        fail(f"prepared {len(records)} records")
    prepared_rows_check(data, mols)
    native = native_transform_check(card, mols[:256])

    cfg = load_config(spec, dataset_path=data, global_batch_size=64,
                      save_path_prefix=os.path.join(root, "prep_models"),
                      num_epochs=1)
    per_fwd = spec.per_forward(cfg)
    replay = per_fwd - spec.per_layer_applied(cfg)
    eval_b = cfg["batch_size"] * cfg["prediction_bmult"]
    steps = math.ceil(len(t3) / cfg["global_batch_size"])
    micro = steps * cfg["global_batch_size"] // cfg["batch_size"]
    val_fwd = (math.ceil(len(v3) / eval_b) * cfg["evaluation_samples"]
               * per_fwd)
    expect = {"train": {"fwd": micro * (per_fwd + replay) + val_fwd,
                        "bwd": micro * per_fwd},
              "evaluate": {"fwd": val_fwd, "bwd": 0}}
    timer = StepTimer(warmup=1)
    launches, out, wall = {}, {}, {}
    with recorded_trainer() as rec:
        step = Trainer.train_step

        def timed_step(self, *args, **kwargs):
            with timer:
                return step(self, *args, **kwargs)

        Trainer.train_step = timed_step
        try:
            for name in ("train", "evaluate"):
                torch.cuda.synchronize()
                reset_counts()                  # the main path starts
                t0 = time.time()
                out[name] = execute(name, dict(cfg))
                torch.cuda.synchronize()
                wall[name] = time.time() - t0
                launches[name] = {"fwd": spec.launches(spec.fwd),
                                  "bwd": spec.launches(spec.bwd)}
                check_only(spec)                # the main path ends
                if isinstance(out[name], dict):
                    out[name].pop("state", None)   # free the card
                torch.cuda.empty_cache()
        finally:
            Trainer.train_step = step
    if launches != expect or rec["plain_core"]:
        fail(f"prepared data: kernel launches {launches}, expected "
             f"{expect}; {rec['plain_core']} plain-core calls")
    losses = [float(m["loss"]) for _, m, _ in rec["steps"]]
    if len(losses) != steps or not all(map(math.isfinite, losses)) or \
            not all(bool(m["ok"]) for _, m, _ in rec["steps"]):
        fail(f"prepared data: training losses {losses}")
    val_loss = out["evaluate"]["val"]["loss"]
    if not math.isfinite(val_loss):
        fail(f"prepared data: evaluate {out['evaluate']}")
    ends = [ev for _, _, ev in rec["steps"]]
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]

    converted, conv_row = converted_checkpoint_check(card, spec, root)
    row = {"runbook": "prepare, train, evaluate, convert, serve",
           "path": spec.name, "model": os.path.relpath(spec.yaml, REPO),
           "card": card, "molecules": n_split, "prepare_s": prepare_s,
           "native_transform": native, "wall_s": wall,
           "train_losses": losses, "val_loss": val_loss,
           "ms_per_step": step_ms, "step_timer": timer.summary(),
           "launches": launches, "expected_launches": expect,
           **conv_row, "phase_s": time.time() - t_phase}
    emit(row)
    print(f"prepared data ({spec.name}) on {card}: prepare "
          f"{prepare_s:.1f} s, train {wall['train']:.1f} s ({steps} steps, "
          f"losses {losses}), evaluate {wall['evaluate']:.1f} s (val loss "
          f"{val_loss}); ms per step (CUDA events) {step_ms}, StepTimer "
          f"{timer.summary()}; phase {row['phase_s']:.1f} s", flush=True)
    return {"fwd": launches["train"]["fwd"] + launches["evaluate"]["fwd"]
            + converted, "bwd": launches["train"]["bwd"]}


# -- phase 7d: data parallelism, two ranks on the card ------------------------------

DDP_WORLD = 2
DDP_TIMEOUT_S = 300     # a rank's bound on its collectives; the parent's on a rank
DDP_GRAD_TOL = 1e-4     # of max|ref| over the flat f32 gradient
DDP_GRAD_SEED = 7


def ddp_config(spec: ModelSpec, root: str, **extra) -> dict:
    """Phase 7's published config on its parquet, global batch 64: 32 per
    rank, no accumulation, one epoch of 3 steps."""
    return load_config(spec, **dict(dict(
        dataset_path=os.path.join(root, "data"), global_batch_size=64,
        num_epochs=1, save_path_prefix=os.path.join(root, "ddp")), **extra))


def ddp_f32_config(spec: ModelSpec, root: str) -> dict:
    """The evaluate of phase 7d's checkpoint in f32, dropout off."""
    return ddp_config(spec, root, mixed_precision=False,
                      predict_in_train=False, evaluation_samples=2)


def ddp_grad_scheme(spec: ModelSpec, root: str, batch_size: int):
    """The published config in f32 with every dropout and noise at 0, one
    micro-batch of ``batch_size`` a rank (32 molecules a step)."""
    from tgt_torch.schemes import get_scheme

    raw = ddp_config(spec, root, mixed_precision=False, source_dropout=0.0,
                     node_act_dropout=0.0, edge_act_dropout=0.0,
                     drop_path=0.0, batch_size=batch_size,
                     global_batch_size=32)
    return get_scheme(raw["scheme"])(raw, command="train")


def ddp_grad_batches(scheme, ranks):
    """Phase 7d's global batch of 32 molecules, seed 14: 16 of 4-16 atoms
    (rank 0's half, bucket 24) and 16 of 40-48 (rank 1's, bucket 48), so
    the halves' valid pairs differ about 15-fold; one device batch on the
    card per entry of ``ranks`` (a rank, or None for all 32)."""
    from tgt_torch.data.collate import padded_collate
    from tgt_torch.data.structural import AddStructuralData
    from tgt_torch.data.synthetic import make_molecule

    rs = np.random.RandomState(14)
    rows = []
    for n in np.concatenate([rs.randint(4, 17, 16), rs.randint(40, 49, 16)]):
        row = make_molecule(rs, int(n))
        row["node_mask"] = np.ones(int(n), np.uint8)
        rows.append(AddStructuralData()(row))
    out = []
    for r in ranks:
        part = rows if r is None else rows[16 * r:16 * (r + 1)]
        host = padded_collate(part, buckets=tuple(scheme.cfg.buckets))
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                    for k, v in scheme.device_batch(host).items()})
    return out


def flat_grad(trainer, model, batch) -> tuple:
    """(loss, flat f32 gradient) of ``Trainer.accumulated_grad`` under
    deterministic algorithms (phase 4r's reason)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, _, grads = trainer.accumulated_grad(model, batch, DDP_GRAD_SEED)
        return float(loss.detach()), torch.cat(
            [g.reshape(-1).float() for g in grads])
    finally:
        torch.use_deterministic_algorithms(before, warn_only=True)


@contextlib.contextmanager
def recorded_all_reduce():
    """CUDA events around each step's gradient all-reduce
    (``Trainer.sum_over_ranks``)."""
    from tgt_torch.training import Trainer

    spans, sum_over_ranks = [], Trainer.sum_over_ranks

    def timed(self, *args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = sum_over_ranks(self, *args)
        end.record()
        spans.append((start, end))
        return out

    Trainer.sum_over_ranks = timed
    try:
        yield spans
    finally:
        Trainer.sum_over_ranks = sum_over_ranks


def ddp_worker(rank: int, port: int, root: str) -> int:
    """One rank of phase 7d, a subprocess of its own on cuda:0 in a gloo
    group of two: train and evaluate through ``execute``, an f32 evaluate,
    and the f32 global gradient with the planted fault; writes what it saw
    to ``<root>/ddp_rank<rank>.json`` (rank 0 also the gradients)."""
    import datetime

    import torch.distributed as dist

    from tgt_torch.cli.execute import execute
    from tgt_torch.ops.kernels import triplet_dense as td
    from tgt_torch.parallel import initialize_distributed
    from tgt_torch.training import Trainer

    spec = ModelSpec("TGT-At", FLAGSHIP_YAML, {}, td.triplet_dense_fwd,
                     td.triplet_dense_bwd)
    initialize_distributed(f"localhost:{port}", DDP_WORLD, rank,
                           backend="gloo", device="cuda:0",
                           timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "wall_s": {}, "launches": {}}
    cfg = ddp_config(spec, root)
    # rank 1 trains into a model dir of its own, which must stay empty:
    # rank 0 alone writes
    train_cfg = cfg if rank == 0 else dict(
        cfg, save_path_prefix=os.path.join(root, "ddp_rank1"))
    torch.cuda.reset_peak_memory_stats()
    with recorded_trainer() as rec, recorded_all_reduce() as spans:
        for name, command, c in (("train", "train", train_cfg),
                                 ("evaluate", "evaluate", cfg),
                                 ("evaluate_f32", "evaluate",
                                  ddp_f32_config(spec, root))):
            torch.cuda.synchronize()
            reset_counts()                  # the main path starts
            t0 = time.time()
            result = execute(command, c, device="cuda:0")
            torch.cuda.synchronize()
            out["wall_s"][name] = time.time() - t0
            out["launches"][name] = {"fwd": spec.launches(spec.fwd),
                                     "bwd": spec.launches(spec.bwd)}
            check_only(spec)                # the main path ends
            out[name] = (result["history"] if command == "train"
                         else result)
            del result
            torch.cuda.empty_cache()
        ends = [ev for _, _, ev in rec["steps"]]
        out["ok"] = [bool(m["ok"]) for _, m, _ in rec["steps"]]
        out["losses"] = [float(m["loss"]) for _, m, _ in rec["steps"]]
        out["ms_per_step"] = [a.elapsed_time(b)
                              for a, b in zip(ends, ends[1:])]
        out["all_reduce_ms"] = [a.elapsed_time(b) for a, b in spans]
        out["plain_core"] = rec["plain_core"]
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # the f32 global gradient, and plain DDP's average of the ranks' own
    # means (the planted fault)
    scheme = ddp_grad_scheme(spec, root, 16)
    trainer = Trainer(scheme, rank=rank, world_size=DDP_WORLD,
                      device="cuda:0")
    model = trainer.init_state(0)["model"]
    batch, = ddp_grad_batches(scheme, [rank])
    out["grad_pairs"] = float(scheme.edge_mask_of(batch).sum())
    loss, grad = flat_grad(trainer, model, batch)
    local, _ = scheme.loss_fn(model, batch, DDP_GRAD_SEED)
    fault = torch.cat([g.reshape(-1).float() for g in torch.autograd.grad(
        local, list(model.parameters()), allow_unused=True)])
    dist.all_reduce(fault)
    fault /= DDP_WORLD
    out.update(grad_loss=loss, local_loss=float(local))
    if rank == 0:
        torch.save({"grad": grad.cpu(), "fault": fault.cpu()},
                   os.path.join(root, "ddp_grad.pt"))
    dist.destroy_process_group()
    with open(os.path.join(root, f"ddp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ddp_ranks(root: str) -> list:
    """Phase 7d's two ranks as subprocesses of this script; fails with
    their output if either fails or outlives DDP_TIMEOUT_S."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ddp-worker", str(r),
         str(port), root], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(DDP_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DDP_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        fail(f"phase 7d: a rank outlived {DDP_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"phase 7d: rank {r} exited {p.returncode}:\n"
                 f"{text[-4000:]}")
    ranks = []
    for r in range(DDP_WORLD):
        with open(os.path.join(root, f"ddp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def same_history(h0: list, h1: list) -> bool:
    """Two ranks' histories agree to 1e-6 relative, wall times excepted."""
    if len(h0) != len(h1):
        return False
    for e0, e1 in zip(h0, h1):
        if e0.keys() != e1.keys():
            return False
        for k, v in e0.items():
            if k.endswith("_time"):
                continue
            if v != e1[k] and not (isinstance(v, float) and math.isclose(
                    v, e1[k], rel_tol=1e-6, abs_tol=1e-9)):
                return False
    return True


def ddp_phase(card, spec: ModelSpec, root: str):
    """Phase 7d: data parallelism on one card, on phase 7's parquet under
    ``root``. (a) two ranks, each a subprocess on cuda:0 in a gloo group,
    train the published config through ``execute`` (global batch 64: 32
    a rank) and evaluate; histories identical, rank 0 alone writes, the
    launches exact on each rank, an f32 evaluate of the two ranks equal
    to one process's. (b) the two ranks' f32 gradient on a global batch
    whose halves differ in size equals one process's on all of it, and
    the average of the ranks' own means (plain DDP) does not. (c) a
    one-rank NCCL group takes the same gradient bitwise."""
    import torch.distributed as dist

    from tgt_torch.cli.execute import execute
    from tgt_torch.training import Trainer

    t_phase = time.time()
    with np.load(os.path.join(root, "data", "splits.npz")) as splits:
        n_split = {k: len(splits[k]) for k in splits.files}
    cfg = ddp_config(spec, root)
    per_fwd = spec.per_forward(cfg)
    replay = per_fwd - spec.per_layer_applied(cfg)
    eval_b = cfg["batch_size"] * cfg["prediction_bmult"]
    per_rank = {s: math.ceil(n_split[s] / DDP_WORLD)
                for s in ("train-3d", "valid-3d")}
    steps = math.ceil(per_rank["train-3d"] / cfg["batch_size"])
    val_fwd = (math.ceil(per_rank["valid-3d"] / eval_b)
               * cfg["evaluation_samples"] * per_fwd)
    f32_fwd = math.ceil(per_rank["valid-3d"] / eval_b) * 2 * per_fwd
    expect = {"train": {"fwd": steps * (per_fwd + replay) + val_fwd,
                        "bwd": steps * per_fwd},
              "evaluate": {"fwd": val_fwd, "bwd": 0},
              "evaluate_f32": {"fwd": f32_fwd, "bwd": 0}}

    ranks = ddp_ranks(root)
    r0, r1 = ranks
    for r in ranks:
        if r["launches"] != expect or r["plain_core"]:
            fail(f"phase 7d rank {r['rank']}: launches {r['launches']}, "
                 f"expected {expect}; {r['plain_core']} plain-core calls")
        if r["ok"] != [True] * steps or not all(
                math.isfinite(x) for x in r["losses"]):
            fail(f"phase 7d rank {r['rank']}: steps {r['ok']}, losses "
                 f"{r['losses']}")
    if not same_history(r0["train"], r1["train"]) or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["val_loss"])
            for h in r0["train"]):
        fail(f"phase 7d: histories {r0['train']} and {r1['train']}")
    if r0["evaluate"] != r1["evaluate"] or \
            r0["evaluate_f32"] != r1["evaluate_f32"]:
        fail(f"phase 7d: evaluate metrics differ between the ranks: "
             f"{r0['evaluate']}, {r1['evaluate']}, {r0['evaluate_f32']}, "
             f"{r1['evaluate_f32']}")
    model_dir = os.path.join(root, "ddp", cfg["model_prefix"],
                             cfg["model_name"])
    for name in ("checkpoint/model.npz", "logs/history.yaml",
                 "predictions/results.yaml"):
        if not os.path.exists(os.path.join(model_dir, name)):
            fail(f"phase 7d: rank 0 did not write {name}")
    rank1_files = [os.path.join(d, f) for d, _, fs in os.walk(
        os.path.join(root, "ddp_rank1")) for f in fs]
    if rank1_files:
        fail(f"phase 7d: rank 1 wrote {rank1_files}")

    # (a) the f32 evaluate of the two ranks against one process's
    reset_counts()
    one = execute("evaluate", ddp_f32_config(spec, root))
    one_fwd = spec.launches(spec.fwd)
    f32 = (r0["evaluate_f32"]["val"]["loss"], one["val"]["loss"])
    f32_rel = abs(f32[0] - f32[1]) / abs(f32[1])
    if f32_rel > 1e-4:
        fail(f"phase 7d: f32 evaluate by two ranks {f32[0]}, by one "
             f"process {f32[1]}")

    # (b) the two ranks' gradient against one process's on all 32
    # molecules; (c) the same through a one-rank NCCL group, bitwise
    scheme = ddp_grad_scheme(spec, root, 32)
    trainer = Trainer(scheme, device="cuda")
    model = trainer.init_state(0)["model"]
    batch, = ddp_grad_batches(scheme, [None])
    ref_loss, ref = flat_grad(trainer, model, batch)
    grad_mb = ref.numel() * 4 / 1e6
    got = torch.load(os.path.join(root, "ddp_grad.pt"))
    scale = float(ref.abs().max())
    err = float((got["grad"].cuda() - ref).abs().max())
    err_fault = float((got["fault"].cuda() - ref).abs().max())
    del got
    if err > DDP_GRAD_TOL * scale:
        fail(f"phase 7d: the two ranks' f32 gradient max|diff| {err}, "
             f"max|ref| {scale}")
    if err_fault <= DDP_GRAD_TOL * scale:
        fail(f"phase 7d: the gradient check does not see plain DDP's "
             f"average of the ranks' means: max|diff| {err_fault}")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", world_size=1, rank=0,
                            init_method=f"tcp://localhost:{free_port()}")
    try:
        nccl_trainer = Trainer(scheme, rank=0, world_size=1, device="cuda")
        if not nccl_trainer.group:
            fail("phase 7d: the Trainer does not see the NCCL group")
        nccl_loss, nccl = flat_grad(nccl_trainer, model, batch)
    finally:
        dist.destroy_process_group()
    nccl_bitwise = bool(torch.equal(nccl, ref)) and nccl_loss == ref_loss
    nccl_version = ".".join(map(str, torch.cuda.nccl.version()))
    if not nccl_bitwise:
        fail(f"phase 7d: the one-rank NCCL gradient differs from the one "
             f"without a group by {float((nccl - ref).abs().max())}")
    del trainer, nccl_trainer, model, batch, ref, nccl
    torch.cuda.empty_cache()

    share = [sum(r["all_reduce_ms"][1:]) / sum(r["ms_per_step"])
             for r in ranks]
    row = {"ddp": "two ranks on cuda:0 over gloo", "path": spec.name,
           "model": os.path.relpath(spec.yaml, REPO), "card": card,
           "molecules_per_rank": per_rank, "steps": steps,
           "wall_s": [r["wall_s"] for r in ranks],
           "ms_per_step": [r["ms_per_step"] for r in ranks],
           "all_reduce_ms": [r["all_reduce_ms"] for r in ranks],
           "all_reduce_share_after_first": share,
           "gradient_mb": grad_mb,
           "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
           "history": r0["train"], "evaluate": r0["evaluate"],
           "launches": [r["launches"] for r in ranks],
           "expected_launches": expect,
           "f32_val_loss_two_ranks": f32[0], "f32_val_loss_one": f32[1],
           "f32_val_loss_rel_diff": f32_rel, "f32_one_launches": one_fwd,
           "grad_pairs_per_rank": [r["grad_pairs"] for r in ranks],
           "grad_loss": ref_loss,
           "grad_local_losses": [r["local_loss"] for r in ranks],
           "grad_max_abs_err": err, "grad_max_abs_err_fault": err_fault,
           "grad_max_abs_ref": scale, "grad_tol": DDP_GRAD_TOL,
           "nccl_version": nccl_version, "nccl_bitwise_equal": nccl_bitwise,
           "phase_s": time.time() - t_phase}
    emit(row)
    print(f"data parallelism ({spec.name}, 2 ranks on one card, gloo) on "
          f"{card}: ms per step {row['ms_per_step']}, all-reduce ms "
          f"{row['all_reduce_ms']} (share after the first step {share}); "
          f"peak memory GB {row['peak_mem_gb']}; f32 gradient max|diff| "
          f"{err}, plain DDP's {err_fault}, of max|ref| {scale}; NCCL "
          f"{nccl_version} one rank bitwise equal; phase "
          f"{row['phase_s']:.1f} s", flush=True)
    return {k: sum(r["launches"][c][k] for r in ranks
                   for c in ("train", "evaluate")) for k in ("fwd", "bwd")}


# -- phase 7q: the pair axis, two ranks on the card ------------------------------

PAIR_WORLD = 2
PAIR_TIMEOUT_S = 600    # a rank's bound on its collectives; the parent's on a rank
PAIR_GRAD_TOL = 1e-4    # of max|ref| over the flat f32 gradient
PAIR_AGX2_HEIGHT = 4    # TGT-Agx2's depth in the aggregate ring's check
PAIR_STEPS = 3          # timed steps on one global batch


def pair_config(spec: ModelSpec, root: str, **extra) -> dict:
    """Phase 7's published config on its parquet with the edge channel
    split over two pair ranks (``num_pair_devices: 2``) and the plain
    triplet path (``use_pallas: false``: tgt_tpu refuses its Pallas kernels
    under a pair mesh); global batch 32, one micro-batch a step on both
    ranks; one epoch on the 64 molecules of the ``valid`` split (2 steps:
    every pair collective goes through host memory), validation on
    valid-3d; 1 draw per evaluation."""
    return load_config(spec, **dict(dict(
        dataset_path=os.path.join(root, "data"), global_batch_size=32,
        num_epochs=1, num_pair_devices=2, use_pallas=False,
        train_split="valid", evaluation_samples=1,
        save_path_prefix=os.path.join(root, "pair")), **extra))


def pair_scheme(spec: ModelSpec, root: str, f32: bool, pair: bool = True,
                **extra):
    """The training scheme of ``pair_config``, on the pair axis or in one
    process; ``f32``: every dropout and noise at 0, 16 molecules a step."""
    from tgt_torch.schemes import get_scheme

    if f32:
        extra = dict(dict(mixed_precision=False, source_dropout=0.0,
                          node_act_dropout=0.0, edge_act_dropout=0.0,
                          drop_path=0.0, batch_size=16,
                          global_batch_size=16), **extra)
    raw = pair_config(spec, root, num_pair_devices=2 if pair else 1, **extra)
    return get_scheme(raw["scheme"])(raw, command="train")


@contextlib.contextmanager
def recorded_pair():
    """The pair axis of every Trainer made inside, its calls, bytes and
    CUDA event pairs (``pair_timing``) per training step, and the shape of
    ``e`` in every pair-sharded layer application, each checked to be
    this rank's half of the rows: (b, N/2, N, edge width)."""
    import tgt_torch.parallel.pair_layer as pl
    import tgt_torch.training.harness as harness
    from tgt_torch.training import Trainer

    rec = {"axes": [], "steps": [], "e_shapes": set()}
    pair_groups, layer = harness.pair_groups, pl.tgt_layer_pair_sharded
    train_step = Trainer.train_step

    def groups(*args):
        out = pair_groups(*args)
        rec["axes"].append(out[2])
        return out

    def sharded(lay, g, axis, **kwargs):
        b, i_loc, n, w = g.e.shape
        if (i_loc * PAIR_WORLD, w) != (n, lay.cfg.edge_width) or \
                axis.size != PAIR_WORLD:
            fail(f"phase 7q: a pair rank holds e as {tuple(g.e.shape)}")
        rec["e_shapes"].add((b, i_loc, n, w))
        return layer(lay, g, axis, **kwargs)

    def step(self, *args, **kwargs):
        if self.pair is None:
            return train_step(self, *args, **kwargs)
        self.pair.reset_stats()
        out = train_step(self, *args, **kwargs)
        rec["steps"].append(dict(self.pair.stats))
        return out

    harness.pair_groups, pl.tgt_layer_pair_sharded = groups, sharded
    Trainer.train_step = step
    try:
        yield rec
    finally:
        harness.pair_groups, pl.tgt_layer_pair_sharded = pair_groups, layer
        Trainer.train_step = train_step


@contextlib.contextmanager
def pair_timing():
    """A pair of CUDA events around each pair collective, kept in its
    axis's ``stats["events"]``."""
    import tgt_torch.parallel.ring as ring

    collective = ring._collective

    def timed(axis, *args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        collective(axis, *args)
        end.record()
        axis.stats.setdefault("events", []).append((start, end))

    ring._collective = timed
    try:
        yield
    finally:
        ring._collective = collective


def collective_ms(stats) -> float:
    return sum(a.elapsed_time(b) for a, b in stats.get("events", ()))


def timed_steps(trainer, batch) -> dict:
    """PAIR_STEPS optimizer steps on one device batch: ms per step (CUDA
    events between the ends of consecutive steps, after the first), the
    pair collectives' bytes and ms per step, and peak memory."""
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ends, stats = [], []
    for i in range(PAIR_STEPS):
        if trainer.pair is not None:
            trainer.pair.reset_stats()
        state, m = trainer.train_step(state, batch, i, seed=i)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        ends.append(end)
        if trainer.pair is not None:
            stats.append(dict(trainer.pair.stats))
        if not bool(m["ok"]):
            fail(f"phase 7q: timed step {i} was not applied")
    torch.cuda.synchronize()
    out = {"ms_per_step": [a.elapsed_time(b) for a, b in zip(ends, ends[1:])],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if stats:
        out.update(collective_calls=[s["calls"] for s in stats],
                   collective_bytes=[s["bytes"] for s in stats],
                   collective_ms=[collective_ms(s) for s in stats])
    del state
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def misplaced_ring_block():
    """A planted fault: the ring places the block of step t at ``my``
    instead of ``(my - t) mod P``."""
    import tgt_torch.parallel.ring as ring

    saved = ring._block_source
    ring._block_source = lambda my, t, p: my
    try:
        yield
    finally:
        ring._block_source = saved


def pair_worker(rank: int, port: int, root: str) -> int:
    """One rank of phase 7q, a subprocess of its own on cuda:0 in a gloo
    group of two, both ranks one pair group: train and evaluate the
    published config through ``execute``, time steps on one global batch,
    and the f32 gradients of TGT-At (with the planted fault) and of
    TGT-Agx2 at reduced depth; writes what it saw to
    ``<root>/pair_rank<rank>.json`` (rank 0 also the gradients)."""
    import datetime

    import torch.distributed as dist

    from tgt_torch.cli.execute import execute
    from tgt_torch.ops.kernels import triplet_aggregate as ta
    from tgt_torch.ops.kernels import triplet_dense as td
    from tgt_torch.parallel import initialize_distributed
    from tgt_torch.parallel.ring import transport
    from tgt_torch.training import Trainer

    at = ModelSpec("TGT-At", FLAGSHIP_YAML, {}, td.triplet_dense_fwd,
                   td.triplet_dense_bwd)
    agx2 = ModelSpec("TGT-Agx2", AGX2_YAML, {}, ta.triplet_aggregate_fwd,
                     ta.triplet_aggregate_bwd)
    initialize_distributed(f"localhost:{port}", PAIR_WORLD, rank,
                           backend="gloo", device="cuda:0",
                           timeout=datetime.timedelta(seconds=PAIR_TIMEOUT_S))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "wall_s": {}, "launches": {}}
    cfg = pair_config(at, root)
    # rank 1 trains into a model dir of its own, which must stay empty:
    # rank 0 alone writes
    train_cfg = cfg if rank == 0 else dict(
        cfg, save_path_prefix=os.path.join(root, "pair_rank1"))
    with recorded_trainer() as rec, recorded_pair() as pair, pair_timing():
        for name, c in (("train", train_cfg), ("evaluate", cfg)):
            torch.cuda.synchronize()
            reset_counts()                  # the main path starts
            t0 = time.time()
            result = execute(name, c, device="cuda:0")
            torch.cuda.synchronize()
            out["wall_s"][name] = time.time() - t0
            out["launches"][name] = {f"{w.__name__}.{a}": getattr(w, a)
                                     for w, a in kernel_counters()}
            out[name] = result["history"] if name == "train" else result
            del result
            torch.cuda.empty_cache()
        out["ok"] = [bool(m["ok"]) for _, m, _ in rec["steps"]]
        out["losses"] = [float(m["loss"]) for _, m, _ in rec["steps"]]
        out["plain_core"] = rec["plain_core"]
        out["train_bytes"] = [s["bytes"] for s in pair["steps"]]
        out["train_collective_ms"] = [collective_ms(s)
                                      for s in pair["steps"]]
        axis = pair["axes"][0]
        out["transport"] = transport(axis, torch.zeros(1).cuda())
        out["pair_index"] = axis.index

        # steps on one global batch of 32 (bf16, as published)
        scheme = pair_scheme(at, root, f32=False)
        trainer = Trainer(scheme, rank=rank, world_size=PAIR_WORLD,
                          device="cuda:0")
        batch, = ddp_grad_batches(scheme, [None])
        out["timed"] = timed_steps(trainer, batch)
        out["e_shapes"] = sorted(pair["e_shapes"])
        del trainer, batch

    # the f32 gradients: TGT-At (and the planted fault), TGT-Agx2
    grads = {}
    for name, spec, extra in (("at", at, {}), ("agx2", agx2, dict(
            model_height=PAIR_AGX2_HEIGHT))):
        scheme = pair_scheme(spec, root, f32=True, **extra)
        trainer = Trainer(scheme, rank=rank, world_size=PAIR_WORLD,
                          device="cuda:0")
        model = trainer.init_state(0)["model"]
        batch, = ddp_grad_batches(scheme, [1])     # 16 of 40-48 atoms
        out[f"grad_loss_{name}"], grads[name] = flat_grad(trainer, model,
                                                          batch)
        if name == "at":
            with misplaced_ring_block():
                _, grads["fault"] = flat_grad(trainer, model, batch)
        del trainer, model, batch
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save({k: v.cpu() for k, v in grads.items()},
                   os.path.join(root, "pair_grad.pt"))
    dist.destroy_process_group()
    with open(os.path.join(root, f"pair_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def pair_ranks(root: str) -> list:
    """Phase 7q's two ranks as subprocesses of this script; fails with
    their output if either fails or outlives PAIR_TIMEOUT_S."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pair-worker", str(r),
         str(port), root], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(PAIR_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PAIR_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        fail(f"phase 7q: a rank outlived {PAIR_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"phase 7q: rank {r} exited {p.returncode}:\n"
                 f"{text[-4000:]}")
    ranks = []
    for r in range(PAIR_WORLD):
        with open(os.path.join(root, f"pair_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def pair_path_grad(scheme, model, batch, axis) -> torch.Tensor:
    """The flat f32 gradient of ``scheme.loss_fn`` through the pair path
    on ``axis``, under deterministic algorithms."""
    from tgt_torch.parallel import pair_scope

    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with pair_scope(axis):
            loss, _ = scheme.loss_fn(model, batch, DDP_GRAD_SEED)
            grads = torch.autograd.grad(loss, list(model.parameters()),
                                        allow_unused=True)
        return torch.cat([(torch.zeros_like(p) if g is None else g)
                          .reshape(-1).float()
                          for g, p in zip(grads, model.parameters())])
    finally:
        torch.use_deterministic_algorithms(before, warn_only=True)


def pair_phase(card, spec: ModelSpec, root: str):
    """Phase 7q: the pair axis on one card, on phase 7's parquet under
    ``root``. (a) two ranks, each a subprocess on cuda:0 in a gloo group,
    one pair group (D=1, P=2): each holds half the rows of the edge
    channel; they train the published config through ``execute`` and
    evaluate, with no triplet kernel and no plain-core call; histories
    identical, rank 0 alone writes; steps on one global batch timed
    against one process's. (b) their f32 gradient of TGT-At, and of
    TGT-Agx2 at 4 layers, equals one process's, and the misplaced ring
    block does not. (c) a one-rank NCCL group takes the pair path's
    gradient bitwise equal to the one with no group."""
    import torch.distributed as dist

    from tgt_torch.ops.kernels import triplet_aggregate as ta
    from tgt_torch.parallel import PairAxis, pair_groups
    from tgt_torch.parallel.ring import transport
    from tgt_torch.training import Trainer

    t_phase = time.time()
    agx2 = ModelSpec("TGT-Agx2", AGX2_YAML, {}, ta.triplet_aggregate_fwd,
                     ta.triplet_aggregate_bwd)
    cfg = pair_config(spec, root)
    ranks = pair_ranks(root)
    r0, r1 = ranks
    zero = {f"{w.__name__}.{a}": 0 for w, a in kernel_counters()}
    for r in ranks:
        if r["launches"] != {"train": zero, "evaluate": zero} or \
                r["plain_core"]:
            fail(f"phase 7q rank {r['rank']}: launches {r['launches']}, "
                 f"{r['plain_core']} plain-core calls")
        if not r["ok"] or not all(r["ok"]) or not all(
                math.isfinite(x) for x in r["losses"]):
            fail(f"phase 7q rank {r['rank']}: steps {r['ok']}, losses "
                 f"{r['losses']}")
        if r["transport"] != "gloo-host" or r["pair_index"] != r["rank"]:
            fail(f"phase 7q rank {r['rank']}: transport {r['transport']}, "
                 f"pair index {r['pair_index']}")
        if not r["e_shapes"] or any(shape[3] != cfg["edge_width"]
                                    for shape in r["e_shapes"]):
            fail(f"phase 7q rank {r['rank']}: e shapes {r['e_shapes']}")
    if r0["losses"] != r1["losses"] or not same_history(
            r0["train"], r1["train"]) or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["val_loss"])
            for h in r0["train"]) or not r0["train"]:
        fail(f"phase 7q: histories {r0['train']} and {r1['train']}, "
             f"losses {r0['losses']}, {r1['losses']}")
    if r0["evaluate"] != r1["evaluate"]:
        fail(f"phase 7q: evaluate metrics differ between the ranks: "
             f"{r0['evaluate']}, {r1['evaluate']}")
    model_dir = os.path.join(root, "pair", cfg["model_prefix"],
                             cfg["model_name"])
    for name in ("checkpoint/model.npz", "logs/history.yaml",
                 "predictions/results.yaml"):
        if not os.path.exists(os.path.join(model_dir, name)):
            fail(f"phase 7q: rank 0 did not write {name}")
    rank1_files = [os.path.join(d, f) for d, _, fs in os.walk(
        os.path.join(root, "pair_rank1")) for f in fs]
    if rank1_files:
        fail(f"phase 7q: rank 1 wrote {rank1_files}")

    # one process's steps on the same global batch
    scheme = pair_scheme(spec, root, f32=False, pair=False)
    trainer = Trainer(scheme, device="cuda")
    batch, = ddp_grad_batches(scheme, [None])
    one = timed_steps(trainer, batch)
    del trainer, batch

    # (b) the f32 gradients against one process's; (c) NCCL, one rank
    got = torch.load(os.path.join(root, "pair_grad.pt"))
    grad = {}
    nccl = {}
    for name, s, extra in (("at", spec, {}), ("agx2", agx2, dict(
            model_height=PAIR_AGX2_HEIGHT))):
        scheme = pair_scheme(s, root, f32=True, pair=False, **extra)
        trainer = Trainer(scheme, device="cuda")
        model = trainer.init_state(0)["model"]
        batch, = ddp_grad_batches(scheme, [1])
        loss, ref = flat_grad(trainer, model, batch)
        scale = float(ref.abs().max())
        grad[name] = {"loss": loss, "max_abs_ref": scale,
                      "max_abs_err": float((got[name].cuda() - ref).abs()
                                           .max())}
        if name == "at":
            grad["fault"] = {"max_abs_err": float(
                (got["fault"].cuda() - ref).abs().max())}
            local = pair_path_grad(scheme, model, batch, PairAxis())
            torch.cuda.set_device(0)
            dist.init_process_group(
                "nccl", world_size=1, rank=0,
                init_method=f"tcp://localhost:{free_port()}")
            try:
                axis = pair_groups(1, 1)[2]
                nccl["transport"] = transport(axis, local)
                through = pair_path_grad(scheme, model, batch, axis)
                nccl["collectives"] = axis.stats["calls"]
            finally:
                dist.destroy_process_group()
            nccl["bitwise_equal"] = bool(torch.equal(through, local))
            nccl["max_abs_err_vs_plain_path"] = float(
                (local - ref).abs().max())
            del local, through
        del trainer, model, batch, ref
        torch.cuda.empty_cache()
    del got
    for name in ("at", "agx2"):
        g = grad[name]
        if not g["max_abs_err"] <= PAIR_GRAD_TOL * g["max_abs_ref"]:
            fail(f"phase 7q: the pair ranks' f32 gradient ({name}) "
                 f"max|diff| {g['max_abs_err']}, max|ref| "
                 f"{g['max_abs_ref']}")
    if grad["fault"]["max_abs_err"] <= PAIR_GRAD_TOL * grad["at"][
            "max_abs_ref"]:
        fail(f"phase 7q: the gradient check does not see the misplaced "
             f"ring block: max|diff| {grad['fault']['max_abs_err']}")
    if nccl["transport"] != "nccl" or not nccl["collectives"] or \
            not nccl["bitwise_equal"]:
        fail(f"phase 7q: the one-rank NCCL pair path: {nccl}")

    timed = [r["timed"] for r in ranks]
    row = {"pair": "two ranks on cuda:0 over gloo, one pair group (D=1, P=2)",
           "path": spec.name, "model": os.path.relpath(spec.yaml, REPO),
           "card": card, "transport": r0["transport"],
           "e_shapes": r0["e_shapes"], "wall_s": [r["wall_s"] for r in ranks],
           "cli_losses": r0["losses"], "history": r0["train"],
           "evaluate": r0["evaluate"],
           "cli_bytes_per_step": [r["train_bytes"] for r in ranks],
           "cli_collective_ms_per_step": [r["train_collective_ms"]
                                          for r in ranks],
           "ms_per_step": [t["ms_per_step"] for t in timed],
           "collective_bytes_per_step": [t["collective_bytes"]
                                         for t in timed],
           "collective_calls_per_step": [t["collective_calls"]
                                         for t in timed],
           "collective_ms_per_step": [t["collective_ms"] for t in timed],
           "peak_mem_gb": [t["peak_mem_gb"] for t in timed],
           "one_process_ms_per_step": one["ms_per_step"],
           "one_process_peak_mem_gb": one["peak_mem_gb"],
           "launches": [r["launches"] for r in ranks],
           "grad": grad, "grad_tol": PAIR_GRAD_TOL, "nccl": nccl,
           "phase_s": time.time() - t_phase}
    emit(row)
    print(f"pair axis ({spec.name}, 2 ranks on one card, {r0['transport']}) "
          f"on {card}: e held as {r0['e_shapes']}; ms per step on one "
          f"global batch of 32 {row['ms_per_step']} against one process's "
          f"{one['ms_per_step']}; pair collectives per step "
          f"{row['collective_bytes_per_step']} bytes in "
          f"{row['collective_ms_per_step']} ms; peak memory GB "
          f"{row['peak_mem_gb']} against {one['peak_mem_gb']}; f32 gradient "
          f"max|diff| TGT-At {grad['at']['max_abs_err']} (fault "
          f"{grad['fault']['max_abs_err']}), TGT-Agx2 "
          f"{grad['agx2']['max_abs_err']}; NCCL one rank bitwise equal; "
          f"phase {row['phase_s']:.1f} s", flush=True)
    return {"fwd": 0, "bwd": 0}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tgt_torch.ops.kernels import _build
    from tgt_torch.ops.kernels import triplet_aggregate as ta
    from tgt_torch.ops.kernels import triplet_attention as tl
    from tgt_torch.ops.kernels import triplet_dense as td

    os.makedirs(os.path.dirname(ROWS_PATH), exist_ok=True)
    open(ROWS_PATH, "w").close()
    card = card_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        emit({"phase": name, "wall_s": time.time() - t0})
        return out

    libs = _build.LIBRARIES
    phase("1 build", _build.build_libraries, libs)
    report = {name: ptxas_report(
        (_build.BUILD_DIR / f"{name}.log").read_text()) for name in libs}
    emit({"ptxas": report})
    spilled = [f for fns in report.values() for f in fns
               if f[0].startswith(BODY_PREFIXES) and (f[2] or f[3])]
    if spilled:
        fail(f"a tensor-core body spills registers: {spilled}")

    at = ModelSpec("TGT-At", FLAGSHIP_YAML, {}, td.triplet_dense_fwd,
                   td.triplet_dense_bwd,
                   stage2=stage2_yamls("tgt_at_200m", "tgt_at"))
    # Path D: the yaml's own node and edge activation-dropout rate on the
    # triplet weights (no published config sets triplet_dropout)
    at_d = ModelSpec("TGT-At Path D", FLAGSHIP_YAML, {"triplet_dropout": 0.1},
                     td.triplet_dense_fwd, td.triplet_dense_bwd,
                     counter="dropout_launches")
    # Path L: the legacy fused pair, one launch for both directions
    at_l = ModelSpec("TGT-At Path L", FLAGSHIP_YAML, {"use_pallas": True},
                     tl.triplet_attention_fwd, tl.triplet_attention_bwd,
                     per_layer=1)
    agx2 = ModelSpec("TGT-Agx2", AGX2_YAML, {"use_pallas": "dense"},
                     ta.triplet_aggregate_fwd, ta.triplet_aggregate_bwd,
                     body_counter="body_launches",
                     fwd_body_counter="body_launches",
                     stage2=stage2_yamls("tgt_agx2_100m", "tgt_agx2"),
                     core="triplet_aggregate_core")

    dense = phase("2 attention fwd kernel", kernel_phase, card)
    dense_bwd = phase("2b attention bwd kernel", backward_kernel_phase, card)
    drop = phase("2c attention kernels at rate > 0", dropout_kernel_phase,
                 card)
    agg, agg_shapes = phase("2d aggregate fwd kernel",
                            aggregate_kernel_phase, card)
    agg_bwd, agg_bwd_shapes = phase("2e aggregate bwd kernel",
                                    aggregate_backward_phase, card)
    legacy = phase("2f legacy fwd kernel", legacy_forward_phase, card)
    legacy_bwd = phase("2g legacy bwd kernel", legacy_backward_phase, card)
    vk = phase("2v forward kernels at the draw-stacked batches",
               vmap_kernel_phase, card)
    big = phase("2r row 1 past 2**31 elements", big_batch_phase, card)

    served, trained = {}, {}
    for tag, spec in (("3", at), ("3d", at_d), ("3l", at_l),
                      ("5", agx2)):
        served[spec.name] = phase(f"{tag} {spec.name} serving",
                                  serving_phase, card, spec)
        trained[spec.name], weights = phase(
            f"{int(tag[0]) + 1}{tag[1:]} {spec.name} training",
            training_phase, card, spec)
        phase(f"{int(tag[0]) + 1}b{tag[1:]} {spec.name} f32 gradients",
              gradient_phase, card, spec, weights)
        del weights
    if not all(all(v.values()) for v in served.values()):
        fail(f"a served path never launched its triplet kernel: {served}")
    remat = phase("4r TGT-At remat policies", remat_policy_phase, card, at)
    indiv = phase("4r TGT-At IndivConfig serving", indiv_serving_phase, card,
                  at)
    with cli_workdir() as root:
        cli = phase("7 TGT-At CLI", cli_phase, card, at, root)
        stage2 = phase("7b TGT-At stage 2", stage2_phase, card, at, root)
        cli_x = phase("7x TGT-Agx2 CLI", cli_phase, card, agx2, root)
        stage2_x = phase("7bx TGT-Agx2 stage 2", stage2_phase, card, agx2,
                         root)
        sched = phase("7v TGT-At MC-draw schedule", schedule_cli_phase, card,
                      at, root)
        prep = phase("7p TGT-At prepared data", prep_phase, card, at, root)
        ddp = phase("7d TGT-At data parallelism", ddp_phase, card, at, root)
        pair = phase("7q TGT-At pair axis", pair_phase, card, at, root)

    def entry(name, source, replaces, by_path, row, ungated=None,
              ungated_train=None):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": row["max_abs_err"], "ms": row["ms"],
               "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
               "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        if ungated is not None:
            out.update(library_ms_ungated=ungated["library_ms"],
                       library=ungated["library"], ms_ungated=ungated["ms"])
        if ungated_train is not None:
            out.update(library_ms_ungated_b32=ungated_train["library_ms"],
                       ms_ungated_b32=ungated_train["ms"])
        return out

    def with_dropout(out, row, by_path):
        out.update(dropout_launches=sum(by_path.values()),
                   dropout={"replaces": td.DROPOUT_REPLACES,
                            **{k: row[k] for k in (
                                "max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}})
        return out

    def shapes(rows, cases):
        """A kernel's rows at the eval and stage-2 batches."""
        return {f"b{c[0]}_n{c[1]}": {k: rows[c].get(k) for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "device_ms", "plain_device_ms", "route", "bitwise_equal")}
            for c in cases}

    def with_device(out, rows, by_shape, **extra):
        """The back-to-back device times at b=16 and b=32 (N=48, bf16) of
        the kernel, its plain version and its library call, and the rows
        at bucket 56 and stage 2's shapes."""
        out.update(extra, device_ms={
            f"b{b}": {k: row[k] for k in (
                "device_ms", "plain_device_ms", "library_device_ms")}
            for b, row in rows.items()}, shapes={
            f"b{b}_n{n}": {k: row.get(k) for k in (
                "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "device_ms", "plain_device_ms",
                "library_device_ms", "route", "bitwise_equal")}
            for (b, n), row in sorted(by_shape.items())})
        return out

    def at_batches(rows):
        """A kernel's rows at the draw-stacked batches of phase 2v."""
        return {f"b{b}_n{n}": {k: row.get(k) for k in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "device_ms", "bitwise_equal")}
            for (b, n), row in sorted(rows.items())}

    d_serve, d_train = served[at_d.name], trained[at_d.name]
    print(f"card: {card}", flush=True)
    emit({"kernels": [
        dict(with_dropout(entry(
            "triplet_dense_fwd", td.KERNEL_SOURCE, td.REPLACES,
            {"serving": served[at.name]["map"],
             "serving_vmap": served[at.name]["vmap"],
             "training": trained[at.name]["fwd"],
             "serving_dropout": d_serve["map"],
             "serving_dropout_vmap": d_serve["vmap"],
             "training_dropout": d_train["fwd"],
             "cli": cli["fwd"], "prep": prep["fwd"], "ddp": ddp["fwd"],
             "pair": pair["fwd"],
             **{k: v["fwd"] for k, v in stage2.items()},
             **{f"remat_{k}": v["fwd"] for k, v in remat.items()},
             "indiv": indiv["triplet_dense_fwd"],
             "evaluate_vmap": sched["evaluate_vmap"]["fwd"],
             "two_stage_vmap": sched["two_stage_vmap"]["fwd"]},
            dense[FLAGSHIP], dense[UNGATED], dense[UNGATED_TRAIN]),
            drop["fwd"], {"serving": d_serve["map"],
                          "serving_vmap": d_serve["vmap"],
                          "training": d_train["fwd"]}),
            eval_batches=shapes(dense, EVAL_CASES),
            vmap_batches=at_batches(vk["triplet_dense_fwd"]),
            dropout_vmap_batches=at_batches(vk["triplet_dense_fwd dropout"]),
            past_2_31=big),
        dict(with_dropout(entry(
            "triplet_dense_bwd", td.BWD_KERNEL_SOURCE, td.BWD_REPLACES,
            {"training": trained[at.name]["bwd"],
             "training_dropout": d_train["bwd"], "cli": cli["bwd"],
             "prep": prep["bwd"], "ddp": ddp["bwd"], "pair": pair["bwd"],
             **{k: v["bwd"] for k, v in stage2.items()},
             **{f"remat_{k}": v["bwd"] for k, v in remat.items()}},
            dense_bwd[FLAGSHIP], dense_bwd[UNGATED],
            dense_bwd[UNGATED_TRAIN]),
            drop["bwd"], {"training": d_train["bwd"]}),
            stage2_micro_batch=shapes(dense_bwd, STAGE2_BWD_CASES)),
        with_device(entry(
            "triplet_aggregate_fwd", ta.KERNEL_SOURCE, ta.REPLACES,
            {"serving": served[agx2.name]["map"],
             "serving_vmap": served[agx2.name]["vmap"],
             "training": trained[agx2.name]["fwd"], "cli": cli_x["fwd"],
             "pair": pair["fwd"],
             **{k: v["fwd"] for k, v in stage2_x.items()},
             "indiv": indiv["triplet_aggregate_fwd"]}, agg[16]), agg,
            agg_shapes,
            vmap_batches=at_batches(vk["triplet_aggregate_fwd"]),
            # every phase of the path fails unless all its bf16 launches
            # took the body; the f32 checks take the panel route
            body_launches=sum(served[agx2.name].values())
            + trained[agx2.name]["fwd_body"]
            + cli_x["fwd_body"] + sum(v["fwd_body"] for v in stage2_x.values())
            + indiv["triplet_aggregate_fwd_body"],
            panel_route={f"b{b}": {k: row[k] for k in (
                "ms_body", "ms_panel_route", "device_ms_panel_route")}
                for b, row in agg.items()}),
        with_device(entry(
            "triplet_aggregate_bwd", ta.BWD_KERNEL_SOURCE, ta.BWD_REPLACES,
            {"training": trained[agx2.name]["bwd"], "cli": cli_x["bwd"],
             "pair": pair["bwd"],
             **{k: v["bwd"] for k, v in stage2_x.items()}}, agg_bwd[16]),
            agg_bwd, agg_bwd_shapes,
            body_launches=trained[agx2.name]["bwd_body"] + cli_x["bwd_body"]
            + sum(v["bwd_body"] for v in stage2_x.values()),
            panel_route={f"b{b}": {k: row[k] for k in (
                "ms_body", "ms_panel_route", "device_ms_panel_route")}
                for b, row in agg_bwd.items()}),
        dict(entry("triplet_attention_fwd", tl.KERNEL_SOURCE, tl.REPLACES,
                   {"serving": served[at_l.name]["map"],
                    "serving_legacy_vmap": served[at_l.name]["vmap"],
                    "training": trained[at_l.name]["fwd"],
                    "pair": pair["fwd"]},
                   legacy[FLAGSHIP], legacy[UNGATED], legacy[UNGATED_TRAIN]),
             vmap_batches=at_batches(vk["triplet_attention_fwd"])),
        entry("triplet_attention_bwd", tl.BWD_KERNEL_SOURCE, tl.BWD_REPLACES,
              {"training": trained[at_l.name]["bwd"], "pair": pair["bwd"]},
              legacy_bwd[FLAGSHIP], legacy_bwd[UNGATED],
              legacy_bwd[UNGATED_TRAIN]),
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:       # one rank of phase 7d
        sys.exit(ddp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--pair-worker"]:      # one rank of phase 7q
        sys.exit(pair_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
