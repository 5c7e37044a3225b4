"""tgt_torch's legacy fused triplet pair (``use_pallas: true``) against
tgt_tpu (CPU, float32 unless stated).

tgt_tpu's ``ops/pallas/triplet_attention.py`` kernels run in interpret mode
under a test-local ``pl.pallas_call`` patch, as ``tests/test_pallas.py``
runs them.
1. The core: ``triplet_biased_attention`` (``TripletCore`` over the plain
   forward and backward on CPU tensors) against tgt_tpu's
   ``triplet_biased_attention`` on the head-major layout, gated and ungated
   (the constant gate 30.0): forward within 1e-5 of max|ref|, the five
   gradients against ``jax.vjp`` within 2e-5 of each max|ref|; in bf16, the
   weights rounded to v's dtype before the product, as the kernel rounds
   them; the plain backward against autograd.
2. ``TripletAttention(use_pallas=True)``: one core call serves both
   directions; output and every parameter's gradient against tgt_tpu's
   ``triplet_attention(..., use_pallas=True)``; dropout in training warns
   and takes the plain path, as tgt_tpu routes it.
3. A 2-layer distance model with ``use_pallas=True`` against tgt_tpu's
   (logits, loss and gradients), ``DistancePredictor.from_model_dir(...,
   use_pallas=True)`` against tgt_tpu's predictor, and the config surface.
"""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.core.graph import additive_mask_from_node_mask
from tgt_tpu.ops.pallas import triplet_attention as jta
from tgt_tpu.ops.triplet import (triplet_attention, triplet_attention_init,
                                 triplet_attention_ungated)
from tgt_tpu.serving import DistancePredictor as JaxDistancePredictor
import tgt_torch.ops.triplet as tri
from tgt_torch.core.config import load_yaml
from tgt_torch.models.convert import state_dict_from_jax_params
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops.kernels.triplet_attention import (
    UNGATED_GATE, triplet_attention_bwd, triplet_attention_fwd,
    triplet_biased_attention, triplet_core_bwd_reference,
    triplet_core_fwd_reference)
from tgt_torch.ops.triplet import TripletAttention
from tgt_torch.profiling import FLAGSHIP_YAML, parse_use_pallas
from tgt_torch.schemes import get_scheme
from tgt_torch.serving import DistancePredictor

from test_torch_port_dropout import assert_scaled_close, graph_inputs
from test_torch_port_serving import model_dir, molecules  # noqa: F401
from test_torch_port_training import (assert_grads_close, first_batch,
                                      port_model, schemes, tensors)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def force_interpret(monkeypatch):
    """tgt_tpu's Pallas TPU kernels run in interpret mode on the CPU."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jta.pl, "pallas_call", patched)
    yield


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def legacy_inputs(b, h, n, d, gated, seed):
    """q_t, k_t, v_t (b, h, N, N, d) and bias, gate (b, h, N, N) with a
    padded sample; ungated, the constant gate 30.0."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, n, n, d).astype(np.float32) for _ in range(3))
    nm = np.ones((b, n), np.float32)
    nm[-1, n - 4:] = 0
    mask = np.asarray(additive_mask_from_node_mask(jnp.asarray(nm)))[..., 0]
    bias = rs.randn(b, h, n, n).astype(np.float32) + mask[:, None]
    gate = (rs.randn(b, h, n, n).astype(np.float32) + mask[:, None] if gated
            else np.full((b, h, n, n), UNGATED_GATE, np.float32))
    return q, k, v, bias, gate


SCALE = 8 ** -0.5
NAMES = ("dq", "dk", "dv", "dbias", "dgate")


class TestLegacyCore:
    @pytest.mark.parametrize("gated", [True, False])
    @pytest.mark.parametrize("shape", [(2, 8, 12, 8), (1, 4, 24, 8)],
                             ids=["b2h8n12", "b1h4n24"])
    def test_forward_and_vjp_match_tgt_tpu(self, shape, gated):
        inputs = legacy_inputs(*shape, gated, seed=50)
        dout = np.random.RandomState(51).randn(*inputs[0].shape).astype(
            np.float32)
        want_out, vjp = jax.vjp(
            lambda *a: jta.triplet_biased_attention(*a, SCALE),
            *(jnp.asarray(x) for x in inputs))
        want = vjp(jnp.asarray(dout))
        leaves = [_t(x, grad=True) for x in inputs]
        out = triplet_biased_attention(*leaves, SCALE)
        out.backward(_t(dout))
        assert_scaled_close(out.detach().numpy(), want_out, 1e-5, "out")
        for name, g, w in zip(NAMES, leaves, want):
            if not gated and name == "dgate":
                # sigmoid(30) is 1.0 in f32: its derivative is exactly 0
                assert not g.grad.any() and not np.asarray(w).any()
                continue
            assert_scaled_close(g.grad.numpy(), w, 2e-5, name)

    def test_bf16_rounds_the_weights_before_the_product(self):
        """In bf16 the kernel casts the weights to v's dtype before the
        product (triplet_attention.py:50); the plain version does too, so
        the two agree to the output's own rounding."""
        inputs = legacy_inputs(2, 4, 12, 8, True, seed=52)
        want = np.asarray(jta.triplet_biased_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in inputs), SCALE),
            np.float32)
        got = triplet_core_fwd_reference(
            *(_t(x).to(torch.bfloat16) for x in inputs), SCALE)
        assert got.dtype == torch.bfloat16
        assert_scaled_close(got.float().numpy(), want, 2 ** -8, "out")

    @pytest.mark.parametrize("gated", [True, False])
    def test_plain_backward_matches_autograd(self, gated):
        inputs = legacy_inputs(2, 4, 8, 8, gated, seed=53)
        dout = _t(np.random.RandomState(54).randn(*inputs[0].shape))
        leaves = [_t(x, grad=True) for x in inputs]
        want = torch.autograd.grad(
            triplet_core_fwd_reference(*leaves, SCALE), leaves, dout)
        got = triplet_core_bwd_reference(*(x.detach() for x in leaves), dout,
                                         SCALE)
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6, msg=name)

    def test_wrappers_check_and_count_no_cpu_launch(self):
        q, k, v, bias, gate = (_t(x) for x in legacy_inputs(1, 2, 6, 4, True,
                                                            seed=55))
        with pytest.raises(ValueError, match="k_t"):
            triplet_attention_fwd(q, k[:, :, :3], v, bias, gate, SCALE)
        with pytest.raises(TypeError):
            triplet_attention_fwd(q, k.double(), v, bias, gate, SCALE)
        with pytest.raises(ValueError, match="cpu or cuda"):
            triplet_attention_fwd(*(x.to("meta") for x in (q, k, v, bias,
                                                           gate)), SCALE)
        before = (triplet_attention_fwd.launches,
                  triplet_attention_bwd.launches)
        out = triplet_attention_fwd(q, k, v, bias, gate, SCALE)
        torch.testing.assert_close(
            out, triplet_core_fwd_reference(q, k, v, bias, gate, SCALE),
            rtol=0, atol=0)
        triplet_attention_bwd(q, k, v, bias, gate, out, SCALE)
        assert (triplet_attention_fwd.launches,
                triplet_attention_bwd.launches) == before


def load_triplet(p, w, h, gated):
    mod = TripletAttention(w, h, gated=gated)
    sd = state_dict_from_jax_params({"m": jax.tree.map(np.asarray, p)},
                                    TGTConfig())
    mod.load_state_dict({k[2:]: v for k, v in sd.items()})
    return mod


def _grad_nodes(t, name):
    """Count autograd nodes called ``name`` reachable from ``t``."""
    seen, stack, hits = set(), [t.grad_fn], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        hits += node.name() == name
        stack.extend(f for f, _ in node.next_functions)
    return hits


class TestLegacyTripletAttention:
    @pytest.mark.parametrize("gated", [True, False])
    def test_matches_tgt_tpu_use_pallas_true(self, gated):
        b, n, w, h = 2, 12, 32, 4
        p = triplet_attention_init(jax.random.PRNGKey(9), w, h, gated=gated)
        e, mask = graph_inputs(b, n, w, 12)
        ct = np.random.RandomState(13).randn(b, n, n, w).astype(np.float32)
        jnp_fn = triplet_attention if gated else triplet_attention_ungated

        def loss(params, ee):
            out = jnp_fn(params, ee, jnp.asarray(mask), num_heads=h,
                         use_pallas=True)
            return jnp.sum(out * jnp.asarray(ct)), out

        (_, want), (jgrads, jge) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(e))
        mod = load_triplet(p, w, h, gated)
        et = _t(e, grad=True)
        got = mod(et, _t(mask), use_pallas=True)
        assert _grad_nodes(got, "TripletCoreBackward") == 1  # both directions
        assert _grad_nodes(got, "TripletDenseCoreBackward") == 0
        assert_scaled_close(got.detach().numpy(), np.asarray(want), 1e-5)
        (got * _t(ct)).sum().backward()
        assert_scaled_close(et.grad.numpy(), np.asarray(jge), 2e-5, "de")
        ref = state_dict_from_jax_params(
            {"m": jax.tree.map(np.asarray, jgrads)}, TGTConfig())
        top = max(float(v.abs().max()) for v in ref.values())
        for name, param in mod.named_parameters():
            # a tensor that only shifts whole softmax rows (lin_E_*.bias)
            # has a zero gradient in exact arithmetic: held to 2e-5 of the
            # module's largest gradient
            want_g = ref["m." + name].numpy()
            scale = np.abs(want_g).max()
            np.testing.assert_allclose(
                param.grad.numpy(), want_g, rtol=0,
                atol=2e-5 * (scale if scale > 1e-3 * top else top),
                err_msg=name)

    def test_dropout_in_training_warns_and_takes_the_plain_path(self):
        """tgt_tpu's routing (ops/triplet.py:295-306): the legacy pair has
        no dropout, so with dropout in training both packages warn and run
        their plain path; deterministic, the kernel runs."""
        b, n, w, h = 2, 8, 32, 4
        p = triplet_attention_init(jax.random.PRNGKey(14), w, h)
        e, mask = graph_inputs(b, n, w, 15)
        with pytest.warns(RuntimeWarning, match="without in-kernel dropout"):
            triplet_attention(p, jnp.asarray(e), jnp.asarray(mask),
                              num_heads=h, attention_dropout=0.3,
                              deterministic=False, rng=jax.random.PRNGKey(0),
                              use_pallas=True)
        mod = load_triplet(p, w, h, True)
        et, mt = torch.from_numpy(e), torch.from_numpy(mask)

        def run(use_pallas, **kw):
            return mod(et, mt, generator=torch.Generator().manual_seed(2),
                       use_pallas=use_pallas, **kw)

        with pytest.warns(RuntimeWarning, match="without in-kernel dropout"):
            got = run(True, attention_dropout=0.3, deterministic=False)
        torch.testing.assert_close(
            got, run(False, attention_dropout=0.3, deterministic=False),
            rtol=0, atol=0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            det = run(True, attention_dropout=0.3, deterministic=True)
        assert _grad_nodes(det, "TripletCoreBackward") == 1
        assert_scaled_close(det.detach().numpy(),
                            run(False).detach().numpy(), 1e-5)


class TestLegacyModel:
    def test_two_layer_model_matches_tgt_tpu(self, tmp_path):
        """A 2-layer TGT-At distance model with ``use_pallas=True`` and its
        dropouts and drop path on (triplet dropout 0): deterministic logits
        against tgt_tpu's, both through the legacy pair; the stochastic
        loss and every gradient against the port's plain path under the
        same seed (the packages' dropout masks differ)."""
        over = dict(use_pallas=True, source_dropout=0.3, drop_path=0.4)
        jscheme, scheme = schemes(tmp_path, **over)
        assert scheme.model_cfg.use_pallas is True
        params = jscheme.init_params(jax.random.PRNGKey(3))
        model = port_model(scheme, params)
        batch = tensors(first_batch(jscheme))
        feed = scheme._model_inputs(batch, scheme.edge_mask_of(batch),
                                    torch.Generator())
        with torch.no_grad():
            logits = model(feed, deterministic=True).numpy()
        ref = np.asarray(jscheme.apply_model(
            params, {k: jnp.asarray(v.numpy()) for k, v in feed.items()},
            deterministic=True))
        np.testing.assert_allclose(logits, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        _, plain_scheme = schemes(tmp_path, **dict(over, use_pallas=False))
        plain = port_model(plain_scheme, params)
        for m, s in ((model, scheme), (plain, plain_scheme)):
            loss, _ = s.loss_fn(m, batch, seed=1)
            loss.backward()
            m.loss = float(loss.detach())
        np.testing.assert_allclose(model.loss, plain.loss, rtol=1e-5)
        for (name, p), (_, q) in zip(model.named_parameters(),
                                     plain.named_parameters()):
            np.testing.assert_allclose(
                p.grad.numpy(), q.grad.numpy(), rtol=0,
                atol=1e-4 * float(q.grad.abs().max()), err_msg=name)

    def test_two_layer_gradients_match_tgt_tpu_without_dropout(self, tmp_path):
        jscheme, scheme = schemes(tmp_path, use_pallas=True)
        params = jscheme.init_params(jax.random.PRNGKey(4))
        db = first_batch(jscheme)
        model = port_model(scheme, params)
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jscheme.loss_fn(p, {k: jnp.asarray(v)
                                          for k, v in db.items()},
                                      jax.random.PRNGKey(1)),
            has_aux=True))(params)
        loss, _ = scheme.loss_fn(model, tensors(db), seed=1)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        assert_grads_close(model, jgrads, scheme.model_cfg)

    def test_from_model_dir_use_pallas_true_matches_tgt_tpu(
            self, model_dir, monkeypatch):  # noqa: F811
        kw = dict(mc_samples=2, batch_size=4, buckets=(16, 32))
        mols = molecules((5, 9, 14, 16, 4, 21))
        ref = JaxDistancePredictor.from_model_dir(str(model_dir),
                                                  use_pallas=True, **kw)
        calls = []
        fused = tri.triplet_attention_fused
        monkeypatch.setattr(tri, "triplet_attention_fused",
                            lambda *a: calls.append(1) or fused(*a))
        ours = DistancePredictor.from_model_dir(str(model_dir),
                                                use_pallas=True,
                                                device="cpu", **kw)
        assert ours.cfg.use_pallas is True
        p_ref = ref.predict(mols)
        p_got = ours.predict(mols)
        # 2 layers x 2 draws x 2 device batches, one call per layer
        assert len(calls) == 8
        np.testing.assert_allclose(p_got, p_ref, rtol=0,
                                   atol=1e-4 * np.abs(p_ref).max())

    def test_config_surface(self):
        assert parse_use_pallas("true") is True
        assert parse_use_pallas("False") is False
        assert parse_use_pallas("dense") == "dense"
        raw = load_yaml(FLAGSHIP_YAML)
        raw.update(use_pallas=True)
        cfg = get_scheme(raw["scheme"])(raw, command="evaluate").model_cfg
        assert cfg.use_pallas is True and cfg.triplet_type == "attention"
