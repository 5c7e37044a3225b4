"""AlphaFold 2's Evoformer in tgt_torch on the CPU: the port's model against
the benchmark's plain float32 reference (``h100bench/reference/
evoformer.py``) with dropout off and on, each MSA op against its
algorithm's direct formula, the outer product mean's hand-written gradient,
the Pairformer's triangle modules unchanged at ``bias=False``, the
synthetic MSA source, the counters and spans, and a training epoch through
``Trainer.train_epoch``.

Tolerances: the port and the reference compute the same float32 math in
different orders (SDPA against an explicit softmax, the dense triplet core
against einsums, one batched product over the sequences against an
einsum), so values agree to a few float32 roundings per layer: 1e-4 of the
largest magnitude, the gradients 1e-4 of each leaf's largest magnitude
(1e-3 for the rare leaf whose largest entry is below a thousandth of the
mean leaf's, where the cancellations of a sum of small terms dominate).
A single op against its formula: 1e-5. The outer product mean's gradient
against autograd's: float64, ``torch.autograd.gradcheck``'s defaults.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h100bench.reference import evoformer as ref
from h100bench.reference import pairformer as pf_ref
from tgt_torch.data import synthetic
from tgt_torch.models.evoformer import EvoformerModel
from tgt_torch.models.heads import make_model
from tgt_torch.ops import msa
from tgt_torch.ops.triangle import TriangleAttention, TriangleMultiplication
from tgt_torch.schemes import get_scheme
from tgt_torch.training.harness import Trainer
from tgt_torch.utils import tracing


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One CPU thread for this file's tests, restored after them: set at
    import, it would hold for every file a worker collects."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

SMALL = dict(num_blocks=2, num_extra_blocks=1, msa_width=16,
             extra_msa_width=8, pair_width=8, msa_heads=2, msa_head_width=4,
             extra_msa_heads=2, extra_msa_head_width=4, opm_width=4,
             tri_mul_width=8, tri_att_heads=2, tri_att_head_width=4)
REF_KEYS = list(SMALL) + [
    "transition_multiplier", "msa_dropout", "pair_dropout",
    "max_relative_offset", "num_dist_bins", "dist_min", "dist_max",
    "max_lr", "lr_warmup_steps",
    "adam_beta1", "adam_beta2", "adam_eps", "clip_grad_norm"]


def _scheme(**over):
    cfg = dict(SMALL, use_pallas="dense", remat=True, batch_size=2,
               synth_train_samples=4, synth_min_tokens=12,
               synth_max_tokens=20, buckets=[20], synth_msa_clusters=6,
               synth_msa_extra=10)
    cfg.update(over)
    return get_scheme("structure.evoformer")(cfg)


def _ref_cfg(scheme) -> dict:
    return {k: getattr(scheme.cfg, k) for k in REF_KEYS}


def _model(scheme, weights):
    with torch.device("meta"):
        model = EvoformerModel(scheme.model_cfg)
    model = model.to_empty(device="cpu")
    model.load_state_dict(weights)
    return model


def _batch(scheme):
    """The shortest and the longest structure, padded to 20 residues, with
    a masked cluster row and masked extra rows."""
    ds = scheme.get_dataset("train")
    rows = sorted((ds[i] for i in range(len(ds))),
                  key=lambda r: r["num_nodes"])
    host = scheme._collate([rows[0], rows[-1]])
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in scheme.device_batch(host).items()}
    batch["msa_mask"][0, -1] = 0
    batch["extra_msa_mask"][1, 7:] = 0
    return batch


def _close(got, want, sel, tol):
    gap = (got - want).detach().abs()[sel].max()
    return float(gap) <= tol * float(want.detach()[sel].abs().max())


@pytest.mark.parametrize("dropout", [False, True])
def test_model_matches_reference(dropout):
    rates = {} if dropout else dict(msa_dropout=0.0, pair_dropout=0.0)
    scheme = _scheme(**rates)
    cfg = _ref_cfg(scheme)
    weights = ref.make_weights(cfg, 7, "cpu")
    model = _model(scheme, weights)
    batch = _batch(scheme)
    nm = batch["node_mask"].float()
    assert int(nm.sum(1).min()) < nm.shape[1]
    seed = 123
    fwd_seed = ref.derive_seed(seed, 1)
    with torch.no_grad():
        got = model(batch, deterministic=False, seed=fwd_seed)
        want = ref.forward(weights, cfg, batch, seed=fwd_seed)
    pairs = (nm[:, :, None] * nm[:, None]).bool()
    assert _close(got[0], want[0], pairs, 1e-4)
    assert _close(got[1], want[1], batch["msa_mask"] > 0, 1e-4)
    # both losses and every gradient
    loss, aux = scheme.loss_fn(model, batch, seed)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    ref_loss = ref.loss_of(leaves, cfg, batch, seed)
    ref_grads = torch.autograd.grad(ref_loss, list(leaves.values()))
    with torch.no_grad():
        dist, masked = ref.losses(weights, cfg, batch, fwd_seed)
    for a, b in ((aux["distogram"], dist), (aux["masked_msa"], masked),
                 (loss.detach(), ref_loss.detach())):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    names = [n for n, _ in model.named_parameters()]
    assert names == list(weights)
    mean = float(np.mean([g.abs().max() for g in ref_grads]))
    for name, g, r in zip(names, grads, ref_grads):
        top = float(r.abs().max())
        tol = 1e-4 if top >= 1e-3 * mean else 1e-3
        assert float((g - r).abs().max()) <= tol * max(top, 1e-3 * mean), name


def _op_inputs():
    torch.manual_seed(0)
    b, s, r, cm, cz = 2, 5, 7, 16, 8
    m = torch.randn(b, s, r, cm, requires_grad=True)
    z = torch.randn(b, r, r, cz, requires_grad=True)
    mask = torch.ones(b, s, r)
    mask[1, :, 5:] = 0              # residues past the second structure
    mask[0, 4] = 0                  # a padded sequence row
    return m, z, mask


def _params(mod, pre="x"):
    for prm in mod.parameters():
        torch.nn.init.uniform_(prm, -0.5, 0.5)
    return {f"{pre}.{k}": v.detach() for k, v in mod.state_dict().items()}


@pytest.mark.parametrize("op", ["row", "column", "global"])
def test_msa_attention_matches_formula(op):
    """Algorithms 7, 8 and 19 against their direct formulas (the
    reference's explicit softmax), over the real rows and residues, and the
    gradients of m and z through them."""
    m, z, mask = _op_inputs()
    h, c = 2, 4
    node = mask.amax(1)
    if op == "row":
        mod = msa.MSARowAttentionWithPairBias(16, 8, h, c)
        p = _params(mod)
        got = mod(m, z, (1.0 - node) * msa.MASK_VALUE)
        want = ref.msa_row_attention(p, "x", m, z, mask, h, c, ref.identity)
    elif op == "column":
        mod = msa.MSAColumnAttention(16, h, c)
        p = _params(mod)
        got = mod(m, mask)
        want = ref.msa_column_attention(p, "x", m, mask, h, c, ref.identity)
    else:
        mod = msa.MSAColumnGlobalAttention(16, h, c)
        p = _params(mod)
        got = mod(m, mask)
        want = ref.msa_global_column_attention(p, "x", m, mask, h, c,
                                               ref.identity)
    real = mask > 0
    assert _close(got, want, real, 1e-5)
    cot = torch.randn_like(got) * real[..., None]
    leaves = [m, z] if op == "row" else [m]
    for g, w in zip(torch.autograd.grad(got, leaves, cot),
                    torch.autograd.grad(want, leaves, cot)):
        assert torch.allclose(g, w, atol=1e-5, rtol=1e-4)


def test_outer_product_mean_normalisation():
    """Algorithm 10 as AlphaFold's code runs it: the projection of the
    summed outer products, bias included, divided by 1e-3 + the count of
    sequences real at both residues."""
    m, _, mask = _op_inputs()
    mod = msa.OuterProductMeanUpdate(16, 8, 4)
    _params(mod)
    with torch.no_grad():
        got = mod(m, mask)
        x = torch.nn.functional.layer_norm(m, (16,), mod.ln.weight,
                                           mod.ln.bias)
        ab = (x @ mod.lin_ab.weight.t() + mod.lin_ab.bias) * mask[..., None]
        a, b = ab[..., :4], ab[..., 4:]
        want = torch.zeros_like(got)
        for i in range(7):
            for j in range(7):
                o = torch.einsum("bsc,bse->bce", a[:, :, i], b[:, :, j])
                y = o.flatten(1) @ mod.lin_out.weight.t() + mod.lin_out.bias
                count = (mask[:, :, i] * mask[:, :, j]).sum(1, keepdim=True)
                want[:, i, j] = y / (1e-3 + count)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    # a padded residue's pairs divide by 1e-3: its projections are zero,
    # so only the bias remains, scaled
    assert torch.allclose(got[1, 6, 6], mod.lin_out.bias / 1e-3, rtol=1e-5)


def test_outer_product_mean_gradient():
    """The hand-written backward against autograd's of the same function,
    float64, with a padded row."""
    torch.manual_seed(1)
    B, s, r, c, cz = 2, 3, 4, 2, 3
    dd = dict(dtype=torch.float64, requires_grad=True)
    a, b = torch.randn(B, s, r, c, **dd), torch.randn(B, s, r, c, **dd)
    weight, bias = torch.randn(cz, c * c, **dd), torch.randn(cz, **dd)
    norm = torch.rand(B, r, r, 1, dtype=torch.float64) + 1.0
    assert torch.autograd.gradcheck(msa.OuterProductMean.apply,
                                    (a, b, weight, bias, norm))
    out = msa.OuterProductMean.apply(a, b, weight, bias, norm)
    plain = (torch.einsum("bsic,bsje->bijce", a, b).flatten(-2)
             @ weight.t() + bias) / norm
    assert torch.allclose(out, plain, atol=1e-12)


def test_pairformer_triangle_modules_unchanged():
    """At the default ``bias=False`` the triangle modules hold the
    parameters they held before the option, and compute the Pairformer
    reference's formulas; ``bias=True`` adds AlphaFold 2's biases, which
    the same formulas take."""
    torch.manual_seed(2)
    b, n, cz = 2, 6, 8
    z = torch.randn(b, n, n, cz)
    nm = torch.ones(b, n)
    nm[1, 4:] = 0
    pair_mask = (nm[:, :, None] * nm[:, None])[..., None]
    key = (1.0 - nm) * pf_ref.MASK_VALUE
    cfg = {"tri_att_heads": 2, "tri_att_head_width": 4}
    for bias in (False, True):
        mul = TriangleMultiplication(cz, 8, True, bias=bias)
        att = TriangleAttention(cz, 2, 4, False, bias=bias)
        mul_names = ["ln_in.weight", "ln_in.bias", "lin_ab.weight",
                     "lin_g.weight", "ln_out.weight", "ln_out.bias",
                     "lin_out.weight"]
        att_names = ["ln.weight", "ln.bias", "lin_QKV.weight",
                     "lin_B.weight", "lin_G.weight", "lin_O.weight"]
        if bias:
            mul_names += ["lin_ab.bias", "lin_g.bias", "lin_out.bias"]
            att_names += ["lin_G.bias", "lin_O.bias"]
        assert sorted(n for n, _ in mul.named_parameters()) == \
            sorted(mul_names)
        assert sorted(n for n, _ in att.named_parameters()) == \
            sorted(att_names)
        if not bias:
            default = TriangleMultiplication(cz, 8, True)
            assert [n for n, _ in default.named_parameters()] == \
                [n for n, _ in mul.named_parameters()]
        p_mul, p_att = _params(mul), _params(att)
        with torch.no_grad():
            got = mul(z, pair_mask)
            want = pf_ref.triangle_multiplication(
                p_mul, "x", z, pair_mask, True, pf_ref.identity)
            assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
            got = att(z, key[:, None, :, None], use_pallas="dense")
            want = pf_ref.triangle_attention(p_att, "x", z, key, False, cfg,
                                             pf_ref.identity)
            valid = (nm[:, :, None] * nm[:, None]).bool()
            assert _close(got, want, valid, 1e-5)


def test_synthetic_msa_source():
    """Feature widths 49 / 25 / 22, the query as row 0, and the masked
    MSA's proportions: 15% of the cluster positions, of which 70% become
    the mask token and the rest a residue or a gap."""
    ds = synthetic.SyntheticMSAStructures(num_samples=2, min_tokens=40,
                                          max_tokens=40, num_clusters=64,
                                          num_extra=32, seed=5)
    again = synthetic.SyntheticMSAStructures(num_samples=2, min_tokens=40,
                                             max_tokens=40, num_clusters=64,
                                             num_extra=32, seed=5)
    row = ds[1]
    assert all(np.array_equal(row[k], again[1][k]) for k in row
               if k != "num_nodes")
    assert row["msa_feat"].shape == (64, 40, 49)
    assert row["extra_msa_feat"].shape == (32, 40, 25)
    assert row["target_feat"].shape == (40, 22)
    assert np.array_equal(row["true_msa"][0], row["restype"])
    assert np.array_equal(row["target_feat"][:, 1:].argmax(1), row["restype"])
    assert (row["msa_feat"][..., :23].sum(-1) == 1).all()
    assert np.allclose(row["msa_feat"][..., 25:48].sum(-1), 1.0, atol=1e-5)
    masked = row["bert_mask"] > 0
    corrupted = row["msa_feat"][..., :23].argmax(-1)
    assert (corrupted[~masked] == row["true_msa"][~masked]).all()
    assert 0.12 < masked.mean() < 0.18
    tokens = (corrupted[masked] == synthetic.MSA_MASK).mean()
    assert 0.6 < tokens < 0.8
    assert row["true_msa"].max() <= synthetic.MSA_GAP


def test_counters_and_backends(monkeypatch):
    """Each op's calls and each SDPA call's backend are counted; every SDPA
    input has a last stride of 1, as the card's fused backends require, and
    the row attention's bias is a stride-0 view over the rows."""
    msa.CALLS.clear()
    scheme = _scheme()
    model = make_model("evoformer", scheme.model_cfg, device="cpu", seed=1)
    sdpa = msa.F.scaled_dot_product_attention
    seen = []

    def spy(q, k, v, attn_mask):
        assert all(t.stride(-1) == 1 for t in (q, k, v, attn_mask))
        seen.append(attn_mask.stride(0))
        return sdpa(q, k, v, attn_mask=attn_mask)

    monkeypatch.setattr(msa.F, "scaled_dot_product_attention", spy)
    with torch.no_grad():
        model(_batch(scheme), deterministic=True)
    blocks = SMALL["num_blocks"] + SMALL["num_extra_blocks"]
    assert seen.count(0) == 2 * blocks       # row attention, 2 structures
    assert msa.CALLS["row_attention"] == blocks
    assert msa.CALLS["column_attention"] == SMALL["num_blocks"]
    assert msa.CALLS["global_column_attention"] == SMALL["num_extra_blocks"]
    assert msa.CALLS["outer_product_mean"] == blocks
    # the row attention loops over the batch's 2 structures
    assert sum(v for k, v in msa.CALLS.items()
               if k.startswith("row_attention.")) == 2 * blocks
    assert sum(v for k, v in msa.CALLS.items()
               if k.startswith("column_attention.")) == SMALL["num_blocks"]


def test_spans_name_each_update():
    scheme = _scheme()
    model = make_model("evoformer", scheme.model_cfg, device="cpu", seed=1)
    batch = _batch(scheme)
    tracing.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            model(batch, deterministic=True)
    rows = tracing.recorded()
    tracing.clear()
    seen = {(r["name"], r["stack"], r.get("kind"), r.get("direction"))
            for r in rows}
    expected = set()
    for stack, kind in (("main", "column"), ("extra", "global")):
        expected |= {("evoformer.msa_row", stack, None, None),
                     ("evoformer.msa_col", stack, kind, None),
                     ("evoformer.msa_transition", stack, None, None),
                     ("evoformer.opm", stack, None, None),
                     ("evoformer.tri_mul", stack, None, "outgoing"),
                     ("evoformer.tri_mul", stack, None, "incoming"),
                     ("evoformer.tri_att", stack, None, "starting"),
                     ("evoformer.tri_att", stack, None, "ending"),
                     ("evoformer.pair_transition", stack, None, None)}
    assert seen == expected
    assert len(rows) == 9 * (SMALL["num_blocks"] + SMALL["num_extra_blocks"])
    assert {r["tokens"] for r in rows} == {batch["node_mask"].shape[1]}
    assert {(r["stack"], r["sequences"]) for r in rows} == {
        ("main", 6), ("extra", 10)}


def test_trains_through_trainer():
    """make_model, the scheme, ``use_pallas: dense`` and remat, through
    ``Trainer.train_epoch``, its clip at 0.1 and its Adam at the published
    values."""
    scheme = _scheme()
    c = scheme.cfg
    assert (c.adam_beta2, c.adam_eps, c.max_lr, c.clip_grad_norm) == \
        (0.999, 1e-6, 1e-3, 0.1)
    trainer = Trainer(scheme, device="cpu")
    state = trainer.init_state(seed=2)
    before = [p.detach().clone() for p in state["model"].parameters()]
    trainer.global_step = 1          # past step 0, whose warm-up rate is 0
    state, logs, stop = trainer.train_epoch(state,
                                            scheme.train_loader(0, 0, 1))
    assert stop is None and np.isfinite(logs["loss"])
    assert trainer.global_step == 3
    for (name, p), a in zip(state["model"].named_parameters(), before):
        assert not torch.equal(a, p), name


def test_checkpoint_tree_round_trip(tmp_path):
    """A structure model's checkpoint tree is flat, one array per
    state_dict key, and ``save_pytree`` / ``load_jax_npz`` give it back."""
    from tgt_torch.models.convert import (jax_params_from_state_dict,
                                          load_jax_npz,
                                          state_dict_from_jax_params)
    from tgt_torch.training.checkpoint import save_pytree
    scheme = _scheme()
    model = make_model("evoformer", scheme.model_cfg, device="cpu", seed=3)
    tree = jax_params_from_state_dict(model.state_dict(), scheme.model_cfg,
                                      model)
    assert list(tree) == list(model.state_dict())
    save_pytree(tree, str(tmp_path / "model.npz"))
    back = state_dict_from_jax_params(load_jax_npz(str(tmp_path /
                                                       "model.npz")),
                                      scheme.model_cfg)
    for name, value in model.state_dict().items():
        assert torch.equal(back[name], value), name
