"""AlphaFold 3's Pairformer in tgt_torch on the CPU: the port's stack
against the benchmark's plain float32 reference (``h100bench/reference/
pairformer.py``), each triangle attention direction on the dense triplet
core against the reference's direct formula, the dense core's plain
version past 128 nodes, the distogram's bins, the spans, and a training
epoch through ``Trainer.train_epoch``.

The single track (single attention with pair bias and the single
transition), which the distogram does not read, is held to the reference
by its own output and by the gradients of a loss read from it.

Tolerances: the port and the reference compute the same float32 math in
different orders (the dense core's (b, j, h, i, k) layout against the
reference's einsums, SDPA against an explicit softmax), so values agree
to a few float32 roundings per layer: 1e-4 of the largest magnitude over
two blocks, the gradients 1e-4 of each leaf's largest magnitude (1e-3 for
the rare leaf whose largest entry is below a thousandth of the mean
leaf's, where the cancellations of a sum of small terms dominate).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h100bench.reference import pairformer as ref
from tgt_torch.data.synthetic import CA_STEP, SyntheticStructures
from tgt_torch.models.heads import make_model
from tgt_torch.models.pairformer import PairformerModel
from tgt_torch.ops.kernels import triplet_dense as td
from tgt_torch.ops.triangle import TriangleAttention
from tgt_torch.schemes import get_scheme
from tgt_torch.schemes.structure import distogram_bins
from tgt_torch.training.harness import Trainer
from tgt_torch.utils import tracing

SMALL = dict(num_blocks=2, single_width=24, pair_width=16, tri_mul_width=16,
             tri_att_heads=2, tri_att_head_width=8, single_heads=2,
             single_head_width=12, transition_multiplier=4)


def _scheme(**over):
    cfg = dict(SMALL, use_pallas="dense", remat=True, batch_size=2,
               synth_train_samples=4, synth_min_tokens=12,
               synth_max_tokens=20, buckets=[20])
    cfg.update(over)
    return get_scheme("structure.distogram")(cfg)


def _ref_cfg(scheme) -> dict:
    c = scheme.cfg
    keys = list(SMALL) + ["pair_dropout", "num_residue_types",
                          "max_relative_offset", "num_dist_bins", "dist_min",
                          "dist_max", "max_lr", "lr_warmup_steps",
                          "adam_beta1", "adam_beta2", "adam_eps"]
    return {k: getattr(c, k) for k in keys}


def _model(scheme, weights):
    with torch.device("meta"):
        model = PairformerModel(scheme.model_cfg)
    model = model.to_empty(device="cpu")
    model.load_state_dict(weights)
    return model


def _batch(scheme):
    """Two structures of 12 and 20 tokens, padded to 20."""
    ds = scheme.get_dataset("train")
    rows = [r for r in (ds[i] for i in range(len(ds)))]
    rows = sorted(rows, key=lambda r: r["num_nodes"])[:1] + \
        sorted(rows, key=lambda r: -r["num_nodes"])[:1]
    host = scheme._collate(rows)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in scheme.device_batch(host).items()}


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_stack_matches_reference(rate):
    scheme = _scheme(pair_dropout=rate)
    cfg = _ref_cfg(scheme)
    weights = ref.make_weights(cfg, 7, "cpu")
    model = _model(scheme, weights)
    batch = _batch(scheme)
    assert int(batch["node_mask"].sum(1).min()) < batch["node_mask"].shape[1]
    seed = 123
    # the forward with the loss's dropout seed
    with torch.no_grad():
        got = model(batch, deterministic=False,
                    seed=ref.derive_seed(seed, 1))
        want = ref.forward(weights, cfg, batch, seed=ref.derive_seed(seed, 1))
    valid = (batch["node_mask"][:, :, None] * batch["node_mask"][:, None]
             ).bool()
    assert (got - want).abs()[valid].max() <= 1e-4 * want[valid].abs().max()
    # the single track, which the distogram does not read: the single
    # representation after the last block, over the structures' tokens
    with torch.no_grad():
        got_s, _ = model.trunk(batch, deterministic=False,
                               seed=ref.derive_seed(seed, 1))
        want_s, _ = ref.trunk(weights, cfg, batch,
                              seed=ref.derive_seed(seed, 1))
    rows = batch["node_mask"].bool()
    assert (got_s - want_s).abs()[rows].max() <= \
        1e-4 * want_s[rows].abs().max()
    # the loss and every gradient
    loss, _ = scheme.loss_fn(model, batch, seed)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    ref_loss = ref.loss_of(leaves, cfg, batch, seed)
    ref_grads = torch.autograd.grad(ref_loss, list(leaves.values()),
                                    allow_unused=True)
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= \
        1e-5 * abs(float(ref_loss.detach()))
    names = [n for n, _ in model.named_parameters()]
    assert names == list(weights)
    # the single track after the embedding feeds nothing the distogram
    # reads: its leaves get no gradient, in both
    unused = [n for n, g in zip(names, grads) if g is None]
    assert unused == [n for n, g in zip(names, ref_grads) if g is None]
    assert unused and all(".single_" in n for n in unused)
    grads, ref_grads = zip(*[(g, r) for g, r in zip(grads, ref_grads)
                             if g is not None])
    names = [n for n in names if n not in unused]
    mean = float(np.mean([g.abs().max() for g in ref_grads]))
    for name, g, r in zip(names, grads, ref_grads):
        top = float(r.abs().max())
        tol = 1e-4 if top >= 1e-3 * mean else 1e-3
        assert float((g - r).abs().max()) <= tol * max(top, 1e-3 * mean), name


def test_single_attention_matches_reference():
    """One block's attention with pair bias (SDPA with the pair bias and
    the key mask as one float mask, heads split as (h, c), the gate on the
    output) against the reference's explicit softmax, over the rows of
    real tokens, with keys masked past them."""
    scheme = _scheme()
    cfg = _ref_cfg(scheme)
    weights = ref.make_weights(cfg, 5, "cpu")
    model = _model(scheme, weights)
    torch.manual_seed(4)
    b, n = 2, 10
    s = torch.randn(b, n, cfg["single_width"])
    z = torch.randn(b, n, n, cfg["pair_width"])
    nm = torch.ones(b, n)
    nm[1, 7:] = 0
    key_mask = (1.0 - nm) * ref.MASK_VALUE
    with torch.no_grad():
        got = model.blocks[0].single_att(s, z, key_mask[:, None, :, None])
        want = ref.attention_pair_bias(weights, "blocks.0.single_att", s, z,
                                       key_mask, cfg, ref.identity)
    rows = nm.bool()
    assert (got - want).abs()[rows].max() <= 1e-4 * want[rows].abs().max()


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_single_track_gradients_match_reference(rate):
    """Every gradient of a loss read from the single representation after
    the last block (a fixed random projection of the real tokens' rows),
    which the distogram's loss never gives: the single attention's SDPA
    backward, its gate and the single transition, and through the pair
    bias every pair update before them."""
    scheme = _scheme(pair_dropout=rate)
    cfg = _ref_cfg(scheme)
    weights = ref.make_weights(cfg, 9, "cpu")
    model = _model(scheme, weights)
    batch = _batch(scheme)
    fwd_seed = ref.derive_seed(77, 1)
    rows = batch["node_mask"][..., None]
    cot = torch.randn(*batch["node_mask"].shape, cfg["single_width"],
                      generator=torch.Generator().manual_seed(3))
    got_s, _ = model.trunk(batch, deterministic=False, seed=fwd_seed)
    grads = torch.autograd.grad((got_s * cot * rows).sum(),
                                list(model.parameters()), allow_unused=True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    want_s, _ = ref.trunk(leaves, cfg, batch, seed=fwd_seed)
    ref_grads = torch.autograd.grad((want_s * cot * rows).sum(),
                                    list(leaves.values()), allow_unused=True)
    names = list(weights)
    # the pair updates of the last block and the head feed nothing s reads
    unused = [n for n, g in zip(names, ref_grads) if g is None]
    assert unused == [n for n, g in zip(names, grads) if g is None]
    assert "blocks.1.single_att.lin_Q.weight" not in unused
    pairs = [(n, g, r) for n, g, r in zip(names, grads, ref_grads)
             if r is not None]
    mean = float(np.mean([r.abs().max() for _, _, r in pairs]))
    for name, g, r in pairs:
        top = float(r.abs().max())
        tol = 1e-4 if top >= 1e-3 * mean else 1e-3
        assert float((g - r).abs().max()) <= tol * max(top, 1e-3 * mean), name


@pytest.mark.parametrize("starting", [True, False])
def test_triangle_attention_on_the_dense_core(starting):
    """Each direction through ``triplet_dense``'s plain core (autograd
    through TripletDenseCore) against the reference's direct formula, with
    keys masked past the structure's tokens."""
    torch.manual_seed(3)
    b, n, cz, h, d = 2, 9, 16, 2, 8
    mod = TriangleAttention(cz, h, d, starting)
    for prm in mod.parameters():
        torch.nn.init.uniform_(prm, -0.5, 0.5)
    pre = "m"
    p = {f"{pre}.{k}": v.detach() for k, v in mod.state_dict().items()}
    z = torch.randn(b, n, n, cz, requires_grad=True)
    nm = torch.ones(b, n)
    nm[1, 6:] = 0
    key_bias = ((1.0 - nm) * ref.MASK_VALUE)[:, None, :, None]
    got = mod(z, key_bias, use_pallas="dense")
    cfg = {"tri_att_heads": h, "tri_att_head_width": d}
    want = ref.triangle_attention(p, pre, z, (1.0 - nm) * ref.MASK_VALUE,
                                  starting, cfg, ref.identity)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    cot = torch.randn_like(got)
    (gz,) = torch.autograd.grad(got, z, cot)
    (wz,) = torch.autograd.grad(want, z, cot)
    assert torch.allclose(gz, wz, atol=1e-5, rtol=1e-4)


def test_dense_core_past_128_nodes():
    """The plain core (the CPU route of ``triplet_dense``) at n = 136,
    ungated, forward and every gradient, against the softmax written out;
    136 is past the bodies' 128, so on the card it takes the tiled route."""
    torch.manual_seed(0)
    b, n, d, h = 1, 136, 2, 1
    assert td.tiled(n) and not td.tiled(td.MAX_NODES)
    q, k, v = (torch.randn(b, n, n, d, h, requires_grad=True) * 0.5
               for _ in range(3))
    bias = torch.randn(b, n, n, h, requires_grad=True)
    leaves = [q, k, v, bias]
    out = td.triplet_dense(q, k, v, bias)
    logits = torch.einsum("bijdh,bjkdh->bjhik", q, k) \
        + bias.permute(0, 3, 1, 2)[:, None]
    want = torch.einsum("bjhik,bjkdh->bjidh", torch.softmax(logits, -1), v)
    assert torch.allclose(out, want, atol=1e-6, rtol=1e-5)
    cot = torch.randn_like(out)
    got_g = torch.autograd.grad(out, leaves, cot)
    want_g = torch.autograd.grad(want, leaves, cot)
    for g, w in zip(got_g, want_g):
        assert torch.allclose(g, w, atol=1e-5, rtol=1e-4)


def test_distogram_bins():
    """64 bins on 2-22 A: 63 evenly spaced edges, a distance's bin the count
    of edges below it; the scheme's and the reference's bins agree."""
    edges = np.linspace(2.0, 22.0, 63)
    dist = torch.tensor([0.0, 1.99, 2.0, 2.01, edges[31] + 1e-3, 21.99,
                         22.0, 22.01, 100.0])
    got = distogram_bins(dist, 64, 2.0, 22.0)
    assert got.tolist() == [0, 0, 0, 1, 32, 62, 62, 63, 63]
    cfg = {"dist_min": 2.0, "dist_max": 22.0, "num_dist_bins": 64}
    assert torch.equal(ref.distogram_bins(dist, cfg), got)
    assert 20.0 / 62 == pytest.approx(float(edges[1] - edges[0]))


def test_synthetic_structures():
    ds = SyntheticStructures(num_samples=3, min_tokens=10, max_tokens=14,
                             seed=4)
    again = SyntheticStructures(num_samples=3, min_tokens=10, max_tokens=14,
                                seed=4)
    for i in range(3):
        r = ds[i]
        n = r["num_nodes"]
        assert 10 <= n <= 14
        assert np.array_equal(r["coords"], again[i]["coords"])
        step = np.linalg.norm(np.diff(r["coords"], axis=0), axis=1)
        assert np.allclose(step, CA_STEP, atol=1e-4)
        assert r["restype"].max() < 20 and (r["asym_id"] == 0).all()
        assert np.array_equal(r["residue_index"], np.arange(n))


def test_spans_name_each_update():
    scheme = _scheme()
    model = make_model("pairformer", scheme.model_cfg, device="cpu", seed=1)
    batch = _batch(scheme)
    tracing.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            model(batch, deterministic=True)
    rows = tracing.recorded()
    tracing.clear()
    seen = {(r["name"], r.get("direction")) for r in rows}
    blocks = scheme.model_cfg.num_blocks
    assert seen == {("pairformer.tri_mul", "outgoing"),
                    ("pairformer.tri_mul", "incoming"),
                    ("pairformer.tri_att", "starting"),
                    ("pairformer.tri_att", "ending"),
                    ("pairformer.transition", "pair"),
                    ("pairformer.transition", "single"),
                    ("pairformer.single", None)}
    assert len(rows) == 7 * blocks
    assert {r["tokens"] for r in rows} == {batch["node_mask"].shape[1]}


def test_trains_through_trainer():
    """make_model, the scheme, ``use_pallas: dense`` and remat, through
    ``Trainer.train_epoch`` and its Adam at the published betas."""
    scheme = _scheme()
    assert scheme.cfg.adam_beta2 == 0.95 and scheme.cfg.max_lr == 1.8e-3
    trainer = Trainer(scheme, device="cpu")
    state = trainer.init_state(seed=2)
    before = [p.detach().clone() for p in state["model"].parameters()]
    trainer.global_step = 1          # past step 0, whose warm-up rate is 0
    state, logs, stop = trainer.train_epoch(state,
                                            scheme.train_loader(0, 0, 1))
    assert stop is None and np.isfinite(logs["loss"])
    assert trainer.global_step == 3
    for (name, p), a in zip(state["model"].named_parameters(), before):
        # the single track feeds nothing the loss reads
        assert torch.equal(a, p) == (".single_" in name), name


@pytest.mark.parametrize("n", [130, 136])
def test_tiled_route_bias_copy(n):
    """The tiled route's head-major bias: (b h, i, k) with the key axis
    zero-padded to a multiple of 8, so that every 16-byte piece of a row
    lies inside it."""
    bias = torch.randn(2, n, n, 3).to(torch.bfloat16)
    got = td._bias_head_major(bias)
    assert got.shape == (6, n, -(-n // 8) * 8) and got.is_contiguous()
    assert torch.equal(got[:, :, :n], bias.permute(0, 3, 1, 2).reshape(6, n, n))
    assert not got[:, :, n:].any()
