"""tgt_torch's aggregate triplet variants (TGT-Agx2), triangular update and
axial attention against tgt_tpu (CPU, float32).

1. The plain k-aggregation core (``triplet_aggregate_fwd``/``_bwd`` on CPU
   tensors) against tgt_tpu's Pallas ``_agg_core`` in interpret mode:
   forward and ``jax.vjp``, contiguous and pair-transposed V, at b=2, N=8,
   W=128, H=16 (d=8), a geometry that passes the JAX kernel's lane rule
   (N*H and d*H multiples of 128); the j axis is padded to JBLK on the JAX
   side as its public entry pads it. Tolerance 1e-5.
2. ``TripletAggregate``, gated and ungated, against
   ``tgt_tpu.ops.triplet.triplet_aggregate(_ungated)`` with
   ``use_pallas="dense"`` (interpret) and ``False``: the output and the
   gradients with respect to e and every parameter, at b=2, N=16, W=128,
   H=8, with a padded sample, so that the gated variant's unmasked out
   direction is pinned (masking it fails the comparison). Tolerance 1e-5 of
   each tensor's max|ref|.
3. ``TriangularUpdate`` and ``AxialAttention``: forward and gradients,
   tolerance as in 2.
4. A 2-layer TGT-Agx2-shaped distance model with ``layer_multiplier=2`` and
   ``use_pallas="dense"`` (``dense_min_nodes=0``, ``dense_min_exact_nodes=0``
   so that tgt_tpu's encoder takes its kernel at N=16): deterministic
   logits to 1e-4 of max|ref|, one ``Trainer`` step against tgt_tpu's
   (loss to 1e-4 relative, parameters within 1e-3 of the learning rate),
   the weight bridge both ways exactly.
5. CPU routing: the wrappers take the plain versions, the launch counters
   stay 0, and the wrappers reject what they cannot take.
6. The folded epilogue of ``TripletAggregate``'s no-grad forward (each
   direction written into its half of one (b, i, j, 2, d, h) buffer, one
   ``lin_O`` GEMM): equal to today's split epilogue, gated (its out
   direction unmasked, a padded sample) and ungated, in f32 to 2e-6 of
   max|ref| and in bf16 within one bf16 step at max|ref|; against tgt_tpu
   on the same weights; ``epilogue_route``, ``takes_pair_buffer`` and which
   route the module takes; the wrapper's ``out`` contract; one entry of
   ``TripletAggregateCore.forward`` per direction on both routes.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.core.graph import additive_mask_from_node_mask
from tgt_tpu.models.convert import convert_torch_state_dict
from tgt_tpu.models.heads import distance_model_apply, distance_model_init
from tgt_tpu.models.model_config import TGTConfig as JaxTGTConfig
from tgt_tpu.ops.pallas.triplet_dense import _agg_core, _jpad
from tgt_tpu.ops.triplet import (axial_attention, axial_attention_init,
                                 triangular_update, triangular_update_init,
                                 triplet_aggregate, triplet_aggregate_init,
                                 triplet_aggregate_ungated)
from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.training import harness as jharness
from tgt_torch.models.convert import state_dict_from_jax_params
from tgt_torch.models.heads import DistanceModel
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops import triplet as port_triplet
from tgt_torch.ops.kernels import triplet_aggregate as port_agg
from tgt_torch.ops.kernels.triplet_aggregate import (
    triplet_aggregate_bwd, triplet_aggregate_bwd_reference,
    triplet_aggregate_core, triplet_aggregate_fwd,
    triplet_aggregate_fwd_reference)
from tgt_torch.ops.triplet import (AxialAttention, TriangularUpdate,
                                   TripletAggregate)
from tgt_torch.schemes import get_scheme
from tgt_torch.training import Trainer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5          # of each tensor's max|ref|


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- 1. the plain core against _agg_core ----------------------------------------

def core_inputs(b, n, w, h, seed=0):
    """Weights a (b, i, k, h) (softmax over k), v (b, j, k, d, h) and a
    cotangent dva (b, j, i, d, h)."""
    rs = np.random.RandomState(seed)
    d = w // h
    logits = rs.randn(b, n, n, h).astype(np.float32)
    a = np.exp(logits) / np.exp(logits).sum(2, keepdims=True)
    v = rs.randn(b, n, n, d, h).astype(np.float32)
    dva = rs.randn(b, n, n, d, h).astype(np.float32)
    return a, v, dva


def jax_agg(a, v, transpose_v):
    """tgt_tpu's ``_agg_core`` (interpret mode) as ``triplet_aggregate_dense``
    calls it: V pair-transposed for the out direction, j padded to JBLK."""
    b, n, _, d, h = v.shape
    if transpose_v:
        v = jnp.swapaxes(v, 1, 2)
    v = jnp.pad(v, ((0, 0), (0, _jpad(n) - n), (0, 0), (0, 0), (0, 0)))
    va = _agg_core(a.reshape(b, n, n * h), v, True)[:, :n]
    return va.reshape(b, n, n, d, h)


class TestPlainCore:
    @pytest.mark.parametrize("transpose_v", [False, True],
                             ids=["contiguous", "transposed"])
    def test_plain_core_matches_agg_core(self, transpose_v):
        a, v, dva = core_inputs(2, 8, 128, 16)
        ref, vjp = jax.vjp(lambda a_, v_: jax_agg(a_, v_, transpose_v),
                           jnp.asarray(a), jnp.asarray(v))
        da_ref, dv_ref = vjp(jnp.asarray(dva))
        at = _t(a).requires_grad_(True)
        vt = _t(v).requires_grad_(True)
        got = triplet_aggregate_core(at, vt.transpose(1, 2) if transpose_v
                                     else vt)
        got.backward(_t(dva))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   **TOL)
        np.testing.assert_allclose(at.grad.numpy(), np.asarray(da_ref), **TOL)
        np.testing.assert_allclose(vt.grad.numpy(), np.asarray(dv_ref), **TOL)

    def test_bf16_returns_input_dtype(self):
        a, v, dva = (_t(x) for x in core_inputs(1, 8, 32, 4, seed=2))
        ref = triplet_aggregate_fwd(a, v)
        got = triplet_aggregate_fwd(a.bfloat16(), v.bfloat16())
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), ref, rtol=0,
                                   atol=2e-2 * float(ref.abs().max()))
        da, dv = triplet_aggregate_bwd(a.bfloat16(), v.bfloat16(),
                                       dva.bfloat16())
        assert da.dtype == dv.dtype == torch.bfloat16

    def test_cpu_path_is_the_plain_version(self):
        a, v, dva = (_t(x) for x in core_inputs(1, 8, 32, 4, seed=3))
        before = (triplet_aggregate_fwd.launches,
                  triplet_aggregate_bwd.launches)
        torch.testing.assert_close(triplet_aggregate_fwd(a, v),
                                   triplet_aggregate_fwd_reference(a, v),
                                   rtol=0, atol=0)
        for x, y in zip(triplet_aggregate_bwd(a, v, dva),
                        triplet_aggregate_bwd_reference(a, v, dva)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert (triplet_aggregate_fwd.launches,
                triplet_aggregate_bwd.launches) == before

    def test_wrapper_rejects_bad_inputs(self):
        a, v, dva = (_t(x) for x in core_inputs(1, 8, 32, 4, seed=4))
        with pytest.raises(ValueError, match="shape"):
            triplet_aggregate_fwd(a[:, :4], v)
        with pytest.raises(ValueError, match="shape"):
            triplet_aggregate_bwd(a, v, dva[:, :, :4])
        with pytest.raises(TypeError):
            triplet_aggregate_fwd(a.double(), v)
        with pytest.raises(ValueError, match="cpu or cuda"):
            triplet_aggregate_fwd(a.to("meta"), v.to("meta"))


# -- 2. and 3. the modules against tgt_tpu ----------------------------------------

def edge_inputs(b, n, w, seed):
    rs = np.random.RandomState(seed)
    e = rs.randn(b, n, n, w).astype(np.float32) * 0.5
    nm = np.ones((b, n), np.float32)
    nm[1, n - 5:] = 0
    mask = np.asarray(additive_mask_from_node_mask(jnp.asarray(nm)))
    cot = rs.randn(b, n, n, w).astype(np.float32)
    return e, mask, cot


def load_module(mod, p):
    sd = state_dict_from_jax_params({"m": np_tree(p)}, TGTConfig())
    mod.load_state_dict({k[2:]: v for k, v in sd.items()})
    return mod


def jax_value_and_grads(fn, p, e, mask, cot):
    """tgt_tpu's output and the gradients of sum(out * cot) with respect to
    the params and e."""
    def loss(p_, e_):
        out = fn(p_, e_, jnp.asarray(mask))
        return (out * jnp.asarray(cot)).sum(), out
    (_, out), (gp, ge) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(p, jnp.asarray(e))
    return np.asarray(out), gp, np.asarray(ge)


def port_value_and_grads(mod, e, mask, cot, **kw):
    et = _t(e).requires_grad_(True)
    out = mod(et, _t(mask), **kw)
    (out * _t(cot)).sum().backward()
    return out.detach().numpy(), et.grad.numpy()


def softmax_shift_entries(name, heads):
    """The bias entries of an aggregate's lin_EG (e_in, e_out) or lin_E
    (both halves) that add one value to every logit of a softmax row: their
    gradient is zero in exact arithmetic, so both sides hold float noise."""
    if name == "lin_EG.bias":
        return np.r_[0:heads, 2 * heads:3 * heads]
    if name == "lin_E.bias" and heads is not None:
        return np.r_[0:2 * heads]
    return None


def assert_module_grads(mod, gp, shift_heads=None):
    """Every parameter's gradient to GRAD_TOL of its max|ref|; the softmax
    shift entries (see above) to GRAD_TOL of the max|ref| of their layer's
    weight gradient, on both sides."""
    ref = {k[2:]: v for k, v in state_dict_from_jax_params(
        {"m": np_tree(gp)}, TGTConfig()).items()}
    names = dict(mod.named_parameters())
    assert set(names) == set(ref)
    for name, p in names.items():
        r, g = ref[name].numpy(), p.grad.numpy()
        shift = softmax_shift_entries(name, shift_heads)
        if shift is not None:
            noise = GRAD_TOL * np.abs(ref[name[:-4] + "weight"].numpy()).max()
            assert np.abs(g[shift]).max() <= noise, name
            assert np.abs(r[shift]).max() <= noise, name
            keep = np.ones(r.shape, bool)
            keep[shift] = False
            r, g = r[keep], g[keep]
            if r.size == 0:
                continue
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=name)


def assert_close_to_max(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=GRAD_TOL * np.abs(ref).max())


class TestTripletAggregate:
    B, N, W, H = 2, 16, 128, 8   # N*H and d*H are 128: tgt_tpu's kernel runs

    def run(self, gated, use_pallas, seed=0, mask_out=None):
        p = triplet_aggregate_init(jax.random.PRNGKey(seed), self.W, self.H,
                                   gated=gated)
        e, mask, cot = edge_inputs(self.B, self.N, self.W, seed)
        jfn = triplet_aggregate if gated else triplet_aggregate_ungated
        ref, gp, ge = jax_value_and_grads(
            lambda p_, e_, m_: jfn(p_, e_, m_, num_heads=self.H,
                                   use_pallas=use_pallas), p, e, mask, cot)
        mod = load_module(TripletAggregate(self.W, self.H, gated=gated), p)
        if mask_out is not None:
            mod.mask_out = mask_out
        got, ge_got = port_value_and_grads(mod, e, mask, cot,
                                           use_pallas=use_pallas)
        return mod, (got, ge_got), (ref, gp, ge)

    @pytest.mark.parametrize("use_pallas", ["dense", False])
    @pytest.mark.parametrize("gated", [True, False],
                             ids=["gated", "ungated"])
    def test_forward_and_grads_match(self, gated, use_pallas):
        mod, (got, ge_got), (ref, gp, ge) = self.run(gated, use_pallas)
        np.testing.assert_allclose(got, ref, **TOL)
        assert_close_to_max(ge_got, ge)
        assert_module_grads(mod, gp, shift_heads=self.H)

    def test_masking_the_gated_out_direction_fails(self):
        """The mutation check of the reference quirk: with the out direction
        masked, the padded sample no longer matches tgt_tpu."""
        _, (got, _), (ref, _, _) = self.run(True, "dense", mask_out=True)
        assert np.abs(got - ref).max() > 100 * TOL["atol"]
        assert np.abs(got[0] - ref[0]).max() <= TOL["atol"] * 10  # unpadded

    def test_use_pallas_true_takes_the_plain_path(self):
        """tgt_tpu's aggregate runs its jnp path for use_pallas=True; the
        port runs its plain path and does not raise."""
        mod = TripletAggregate(32, 4)
        e, mask = torch.randn(1, 6, 6, 32), torch.zeros(1, 6, 6, 1)
        torch.testing.assert_close(mod(e, mask, use_pallas=True),
                                   mod(e, mask, use_pallas=False),
                                   rtol=0, atol=0)

    def test_attention_dropout_on_the_weights(self):
        mod = TripletAggregate(32, 4)
        e, mask = torch.randn(1, 6, 6, 32), torch.zeros(1, 6, 6, 1)
        base = mod(e, mask, use_pallas="dense")
        outs = [mod(e, mask, attention_dropout=0.5, deterministic=False,
                    generator=torch.Generator().manual_seed(s),
                    use_pallas="dense") for s in (0, 0, 1)]
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
        assert not torch.equal(outs[0], base)
        assert not torch.equal(outs[0], outs[2])

    @pytest.mark.parametrize("gated", [True, False])
    def test_state_dict_names(self, gated):
        bias = "lin_EG" if gated else "lin_E"
        names = set(TripletAggregate(32, 4, gated=gated).state_dict())
        assert names == {f"{m}.{t}" for m in ("tri_ln_e", "lin_V", bias,
                                               "lin_O")
                         for t in ("weight", "bias")}


class TestOtherVariants:
    B, N, W, H = 2, 12, 32, 4

    @pytest.mark.parametrize("name", ["triangular_update", "axial_attention"])
    def test_forward_and_grads_match(self, name):
        init, jfn, cls = {
            "triangular_update": (triangular_update_init, triangular_update,
                                  TriangularUpdate),
            "axial_attention": (axial_attention_init, axial_attention,
                                AxialAttention),
        }[name]
        p = init(jax.random.PRNGKey(4), self.W, self.H)
        e, mask, cot = edge_inputs(self.B, self.N, self.W, seed=4)
        ref, gp, ge = jax_value_and_grads(
            lambda p_, e_, m_: jfn(p_, e_, m_, num_heads=self.H), p, e, mask,
            cot)
        mod = load_module(cls(self.W, self.H), p)
        got, ge_got = port_value_and_grads(mod, e, mask, cot,
                                           use_pallas="dense")
        np.testing.assert_allclose(got, ref, **TOL)
        assert_close_to_max(ge_got, ge)
        assert_module_grads(mod, gp)


# -- 4. a 2-layer TGT-Agx2-shaped distance model ------------------------------------

AGX2 = dict(node_width=64, edge_width=128, num_heads=8, model_height=2,
            layer_multiplier=2, triplet_heads=8, triplet_type="aggregate",
            num_dist_bins=16, use_pallas="dense", dense_min_nodes=0,
            dense_min_exact_nodes=0)


def agx2_cfgs():
    kw = dict(AGX2, node_ended=False, edge_ended=True)
    return JaxTGTConfig(**kw), TGTConfig(**kw)


def model_batch(b, n, seed):
    rs = np.random.RandomState(seed)
    nm = np.zeros((b, n), np.float32)
    for i, c in enumerate([n] + list(rs.randint(3, n, size=b - 1))):
        nm[i, :c] = 1
    nodef = np.stack([rs.randint(1, 33, size=(b, n)) + k * 128
                      for k in range(9)], axis=-1) * nm[..., None].astype(int)
    featm = np.stack([rs.randint(1, 8, size=(b, n, n)) + k * 8
                      for k in range(3)], axis=-1)
    coords = rs.randn(b, n, 3).astype(np.float32) * 2
    return {
        "node_features": nodef.astype(np.int32),
        "distance_matrix": rs.randint(0, 34, size=(b, n, n)).astype(np.int32),
        "feature_matrix": featm.astype(np.int32),
        "node_mask": nm,
        "edge_mask": nm[:, :, None] * nm[:, None, :],
        "dist_input": np.linalg.norm(coords[:, :, None] - coords[:, None],
                                     axis=-1).astype(np.float32),
    }


class TestAgx2Model:
    def test_logits_match_distance_model_apply(self):
        jcfg, cfg = agx2_cfgs()
        params = distance_model_init(jax.random.PRNGKey(1), jcfg)
        batch = model_batch(2, 16, seed=1)
        ref = np.asarray(jax.jit(lambda p, x: distance_model_apply(
            p, x, jcfg, deterministic=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()}))
        model = DistanceModel(cfg).requires_grad_(False)
        model.load_state_dict(state_dict_from_jax_params(np_tree(params), cfg))
        before = triplet_aggregate_fwd.launches
        got = model({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
        assert triplet_aggregate_fwd.launches == before   # no kernel on CPU
        assert got.shape == (2, 16, 16, 16)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())

    def test_weight_bridge_round_trip(self):
        jcfg, cfg = agx2_cfgs()
        params = distance_model_init(jax.random.PRNGKey(0), jcfg)
        model = DistanceModel(cfg)
        model.load_state_dict(state_dict_from_jax_params(np_tree(params), cfg))
        assert "encoder.TGT_layers.0.tria.lin_EG.weight" in model.state_dict()
        back = convert_torch_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, params, jcfg)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_trainer_step_matches_tgt_tpu(self, tmp_path):
        """One step of accumulation 2 with remat. SGD at a constant 1e-3, so
        that each parameter's step is linear in its gradient: Adam's first
        step g / (|g| + eps) turns a gradient of eps size into a step set by
        its float noise (Adam itself is held against tgt_tpu on equal
        gradients in test_torch_port_training.py)."""
        over = dict(AGX2, dataset_source="synthetic", synth_train_samples=8,
                    synth_max_nodes=14, batch_size=4, global_batch_size=8,
                    buckets=[16], remat=True, optimizer="sgd", max_lr=1e-3,
                    min_lr=1e-3, lr_warmup_steps=1, lr_total_steps=100,
                    save_path_prefix=str(tmp_path))
        jscheme = jax_get_scheme("pcqm.dist_pred")(dict(over, use_mesh=False))
        scheme = get_scheme("pcqm.dist_pred")(over)
        jtrainer = jharness.Trainer(jscheme)
        trainer = Trainer(scheme, device="cpu")
        assert trainer.grad_accum == jtrainer.grad_accum == 2
        jstate = jtrainer.init_state(jax.random.PRNGKey(0))
        state = trainer.init_state()
        first = state_dict_from_jax_params(np_tree(jstate["params"]),
                                           scheme.model_cfg)
        state["model"].load_state_dict(first)
        db = jscheme.device_batch(next(iter(jscheme.train_loader(0, 0, 1))))
        counts = (triplet_aggregate_fwd.launches,
                  triplet_aggregate_bwd.launches)
        jstate, jm = jtrainer.build_train_step()(
            jstate, jtrainer.shard_device_batch(db), jnp.asarray(0),
            jax.random.PRNGKey(0), jnp.asarray(1.0))
        state, m = trainer.train_step(
            state, trainer.to_device(trainer.pad_device_batch(db)), 0, seed=0)
        assert (triplet_aggregate_fwd.launches,
                triplet_aggregate_bwd.launches) == counts
        assert bool(m["ok"]) and bool(jm["ok"])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        lr = m["lr"]
        assert abs(lr - float(jm["lr"])) <= 1e-9 and abs(lr - 1e-3) <= 1e-9
        ref = state_dict_from_jax_params(np_tree(jstate["params"]),
                                         scheme.model_cfg)
        moved = 0
        for k, v in state["model"].state_dict().items():
            r = ref[k].numpy()
            # 1e-3 of the learning rate, plus one f32 rounding
            bound = 1e-3 * lr + np.spacing(np.abs(r))
            err = np.abs(v.numpy() - r)
            assert np.all(err <= bound), (k, float(err.max()))
            moved += int(np.abs(r - first[k].numpy()).max() > 1e-3 * lr)
        assert moved > len(ref) // 2      # the steps exceed the bound


# -- 6. the folded epilogue of the no-grad forward ------------------------------------

FOLD_B, FOLD_N, FOLD_W, FOLD_H = 2, 16, 128, 8     # d = 16, as TGT-Agx2's


def fold_module(gated, seed=0):
    """A TripletAggregate whose weights come from tgt_tpu's initialiser, and
    edge inputs with a padded sample."""
    p = triplet_aggregate_init(jax.random.PRNGKey(seed), FOLD_W, FOLD_H,
                               gated=gated)
    e, mask, _ = edge_inputs(FOLD_B, FOLD_N, FOLD_W, seed)
    return load_module(TripletAggregate(FOLD_W, FOLD_H, gated=gated), p), \
        p, _t(e), _t(mask)


@pytest.fixture
def routes(monkeypatch):
    """The routes ``TripletAggregate`` asks for, in order."""
    taken = []

    route = port_triplet.epilogue_route

    def recorded(*args):
        taken.append(route(*args))
        return taken[-1]

    monkeypatch.setattr(port_triplet, "epilogue_route", recorded)
    return taken


def bf16_steps(got, ref):
    """max|got - ref| in bf16 steps at max|ref|."""
    _, exp = torch.frexp(ref.float().abs().max())
    step = 2.0 ** (int(exp) - 8)
    return float((got.float() - ref.float()).abs().max()) / step


class TestFoldedEpilogue:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    @pytest.mark.parametrize("gated", [True, False],
                             ids=["gated", "ungated"])
    def test_fold_equals_split(self, gated, dtype, routes):
        mod, _, e, mask = fold_module(gated)
        e, mask = e.to(dtype), mask.to(dtype)
        split = mod(e, mask, use_pallas="dense").detach()   # autograd records
        with torch.no_grad():
            fold = mod(e, mask, use_pallas="dense")
        assert routes == ["split", "fold"]
        assert fold.is_contiguous() and not split.is_contiguous()
        assert fold.dtype == split.dtype == dtype
        # the padded sample's rows and the gated out direction's unmasked
        # columns are compared with the rest
        if dtype == torch.float32:
            np.testing.assert_allclose(fold.numpy(), split.numpy(), rtol=0,
                                       atol=2e-6 * float(split.abs().max()))
        else:
            assert bf16_steps(fold, split) <= 1.0

    @pytest.mark.parametrize("gated", [True, False],
                             ids=["gated", "ungated"])
    def test_fold_matches_tgt_tpu(self, gated, routes):
        mod, p, e, mask = fold_module(gated, seed=5)
        jfn = triplet_aggregate if gated else triplet_aggregate_ungated
        ref = np.asarray(jfn(p, jnp.asarray(e.numpy()),
                             jnp.asarray(mask.numpy()), num_heads=FOLD_H,
                             use_pallas="dense"))
        with torch.inference_mode():
            got = mod(e, mask, use_pallas="dense").numpy()
        assert routes == ["fold"]
        np.testing.assert_allclose(got, ref, **TOL)

    @pytest.mark.parametrize("dense,heads,grad,want", [
        (True, 8, False, "fold"),       # both directions take the buffer
        (True, 8, True, "split"),       # autograd records
        (True, 4, False, "split"),      # H % 8, f32 or outside the body
        (False, 8, False, "split")])    # the plain path
    def test_route(self, dense, heads, grad, want):
        a, v = torch.zeros(2, 4, 4, heads), torch.zeros(2, 4, 4, 3, heads)
        assert port_triplet.epilogue_route(dense, grad, a, v) == want

    @pytest.mark.parametrize("route,heads,want", [
        ("plain", 8, True),             # the CPU: the plain version writes out
        ("body", 8, True),              # the card: the body takes out
        ("panel", 8, False),            # f32 or a shape outside the body
        ("plain", 4, False),            # H % 8: a half misses out's contract
        ("body", 12, False)])
    def test_takes_pair_buffer(self, monkeypatch, route, heads, want):
        monkeypatch.setattr(port_agg, "fwd_route", lambda a, v: route)
        a, v = torch.zeros(2, 4, 4, heads), torch.zeros(2, 4, 4, 3, heads)
        assert port_agg.takes_pair_buffer(a, v) is want

    def test_what_takes_the_buffer(self):
        """On the CPU every call takes the plain route, whatever the dtype
        and strides, so the module folds wherever the buffer's halves meet
        ``out``'s contract: H a multiple of 8, which it tests itself."""
        a, v = torch.zeros(2, 4, 4, 8), torch.zeros(2, 4, 4, 3, 8)
        assert port_agg.fwd_route(a, v) == "plain"
        assert port_agg.fwd_route(a.bfloat16().transpose(1, 2),
                                  v.bfloat16().transpose(1, 2)) == "plain"

    def test_module_routes_by_what_autograd_records(self, routes):
        mod, _, e, mask = fold_module(True)
        mod(e, mask, use_pallas="dense")                   # parameters
        mod(e.requires_grad_(True), mask, use_pallas="dense")
        with torch.no_grad():
            mod(e, mask, use_pallas="dense")
        mod.requires_grad_(False)
        mod(e.detach(), mask, use_pallas="dense")          # nothing to record
        with torch.no_grad():
            mod(e, mask, use_pallas=False)                 # the plain path
            TripletAggregate(32, 4)(torch.randn(1, 6, 6, 32),  # H % 8
                                    torch.zeros(1, 6, 6, 1), use_pallas="dense")
        assert routes == ["split", "split", "fold", "fold", "split", "split"]

    def test_one_core_entry_per_direction(self, monkeypatch):
        """Each direction enters ``TripletAggregateCore.forward`` once on
        both routes (the benchmark marks that entry point), the fold's with
        its half of the buffer."""
        entries = []
        forward = port_agg.TripletAggregateCore.forward

        def counted(ctx, a, v, out=None):
            entries.append(out is not None)
            return forward(ctx, a, v, out)

        monkeypatch.setattr(port_agg.TripletAggregateCore, "forward",
                            staticmethod(counted))
        mod, _, e, mask = fold_module(False)
        mod(e, mask, use_pallas="dense")
        with torch.no_grad():
            mod(e, mask, use_pallas="dense")
        assert entries == [False, False, True, True]


class TestOutContract:
    def inputs(self):
        a, v, _ = (_t(x) for x in core_inputs(2, 8, 64, 8, seed=6))
        return a, v                             # v (2, 8, 8, 8, 8)

    @pytest.mark.parametrize("axis", [3, 4], ids=["t_d_h", "d_t_h"])
    def test_pair_order_halves_hold_each_direction(self, axis):
        """Both directions into the halves of one (b, i, j, 2, d, h)
        buffer (the layer's) or (b, i, j, d, 2, h)."""
        a, v = self.inputs()
        b, n, _, d, h = v.shape
        shape = [b, n, n, d, h]
        shape.insert(axis, 2)
        buf = torch.full(shape, float("nan"))
        halves = buf.transpose(1, 2).unbind(axis)
        got = [triplet_aggregate_fwd(a, x, out=half) for x, half in
               zip((v, v.transpose(1, 2)), halves)]
        for x, half, out in zip((v, v.transpose(1, 2)), halves, got):
            assert out is half
            torch.testing.assert_close(half, triplet_aggregate_fwd(a, x),
                                       rtol=0, atol=0)
        assert not bool(buf.isnan().any())

    def test_core_writes_out_only_without_gradient(self):
        a, v = self.inputs()
        out = torch.empty_like(v)
        with torch.no_grad():
            assert triplet_aggregate_core(a, v, out) is not None
        torch.testing.assert_close(out, triplet_aggregate_fwd(a, v),
                                   rtol=0, atol=0)
        with pytest.raises(RuntimeError, match="autograd"):
            triplet_aggregate_core(a.requires_grad_(True), v, out)

    @pytest.mark.parametrize("bad", ["shape", "dtype", "h_strided",
                                     "stride_8", "unaligned"])
    def test_out_contract_raises(self, bad):
        a, v = self.inputs()
        b, n, _, d, h = v.shape
        out = {
            "shape": lambda: torch.empty(b, n, n - 1, d, h),
            "dtype": lambda: torch.empty(b, n, n, d, h, dtype=torch.float64),
            "h_strided": lambda: torch.empty(b, n, n, h, d).transpose(3, 4),
            "stride_8": lambda: torch.empty(b, n, n, d, h + 4)[..., :h],
            "unaligned": lambda: torch.empty(v.numel() + 8)[1:v.numel() + 1]
            .view(v.shape),
        }[bad]()
        with pytest.raises((ValueError, TypeError),
                           match="shape|out is|strides|aligned"):
            triplet_aggregate_fwd(a, v, out=out)
