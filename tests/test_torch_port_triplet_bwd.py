"""Gradients of tgt_torch's dense triplet core against tgt_tpu (CPU, float32).

1. ``triplet_dense`` (``TripletDenseCore``: on CPU tensors the plain forward
   and the plain backward ``triplet_dense_bwd_reference``) against
   ``jax.vjp`` of tgt_tpu's custom-VJP ``_dense_core`` in interpret mode
   (j-padded as its public entry pads it) and of the jnp core, at the
   geometries of ``test_torch_port_triplet.py``, gated and ungated, to 1e-5.
2. ``triplet_dense_bwd_reference`` against ``torch.autograd.grad`` through
   the plain forward.
3. The out direction's strided K/V views, a head at -300 and a fully masked
   sample.
4. ``TripletAttention`` with ``use_pallas='dense'`` differentiates through
   ``TripletDenseCore``, and its parameter gradients equal tgt_tpu's.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.core.graph import additive_mask_from_node_mask
from tgt_tpu.ops.triplet import (triplet_attention, triplet_attention_init,
                                 triplet_attention_ungated)
from tgt_torch.models.convert import state_dict_from_jax_params
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops.kernels.triplet_dense import (triplet_dense,
                                                 triplet_dense_bwd,
                                                 triplet_dense_bwd_reference,
                                                 triplet_dense_fwd_reference)
from tgt_torch.ops.triplet import TripletAttention

from test_torch_port_triplet import (GEOMETRIES, core_inputs, jnp_core,
                                     pallas_core)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def port_grads(q, k, v, bias, gate, dva):
    """(dq, dk, dv, dbias, dgate) of ``triplet_dense`` by autograd."""
    leaves = [None if x is None else _t(x, grad=True)
              for x in (q, k, v, bias, gate)]
    triplet_dense(*leaves).backward(_t(dva))
    return [None if x is None else x.grad.numpy() for x in leaves]


def jax_grads(core, q, k, v, bias, gate, dva):
    """The same five gradients by ``jax.vjp`` of a tgt_tpu core."""
    if gate is None:
        _, vjp = jax.vjp(lambda *a: core(*a, None),
                         *(jnp.asarray(x) for x in (q, k, v, bias)))
        return list(vjp(jnp.asarray(dva))) + [None]
    _, vjp = jax.vjp(core, *(jnp.asarray(x) for x in (q, k, v, bias, gate)))
    return list(vjp(jnp.asarray(dva)))


def cotangent(q, seed):
    """A random dva (b, j, i, d, h)."""
    return np.random.RandomState(seed).randn(*q.shape).astype(np.float32)


def assert_grads_close(got, want, **tol):
    assert len(got) == len(want) == 5
    for name, g, w in zip(("dq", "dk", "dv", "dbias", "dgate"), got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                   err_msg=name)


class TestBackwardCore:
    @pytest.mark.parametrize("gated", [True, False])
    @pytest.mark.parametrize("geom", GEOMETRIES, ids=["N16H8", "N24H16"])
    def test_matches_pallas_and_jnp_vjp(self, geom, gated):
        q, k, v, bias, gate = core_inputs(*geom, seed=10)
        gate = gate if gated else None
        dva = cotangent(q, 11)
        got = port_grads(q, k, v, bias, gate, dva)
        assert_grads_close(got, jax_grads(pallas_core, q, k, v, bias, gate,
                                          dva), **TOL)
        assert_grads_close(got, jax_grads(jnp_core, q, k, v, bias, gate, dva),
                           **TOL)

    @pytest.mark.parametrize("gated", [True, False])
    def test_reference_matches_autograd_of_plain_forward(self, gated):
        q, k, v, bias, gate = core_inputs(2, 8, 32, 4, seed=12)
        gate = gate if gated else None
        dva = _t(cotangent(q, 13))
        leaves = [None if x is None else _t(x, grad=True)
                  for x in (q, k, v, bias, gate)]
        out = triplet_dense_fwd_reference(*leaves)
        want = torch.autograd.grad(out, [x for x in leaves if x is not None],
                                   dva)
        got = triplet_dense_bwd_reference(
            *(None if x is None else x.detach() for x in leaves), dva)
        assert got[4] is None if not gated else got[4] is not None
        for g, w in zip([x for x in got if x is not None], want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)

    def test_strided_views_match_contiguous(self):
        """The out direction hands the core pair-transposed views of K and
        V: their gradients equal those of contiguous copies."""
        q, k, v, bias, gate = core_inputs(2, 8, 32, 4, seed=14)
        dva = _t(cotangent(q, 15))
        kt, vt = _t(k, grad=True), _t(v, grad=True)
        qa, ba, ga = (_t(x, grad=True) for x in (q, bias, gate))
        triplet_dense(qa, kt.transpose(1, 2), vt.transpose(1, 2), ba,
                      ga).backward(dva)
        kc = kt.detach().transpose(1, 2).contiguous().requires_grad_()
        vc = vt.detach().transpose(1, 2).contiguous().requires_grad_()
        qb, bb, gb = (_t(x, grad=True) for x in (q, bias, gate))
        triplet_dense(qb, kc, vc, bb, gb).backward(dva)
        for a, b in ((qa, qb), (ba, bb), (ga, gb)):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(kt.grad.transpose(1, 2), kc.grad,
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(vt.grad.transpose(1, 2), vc.grad,
                                   rtol=1e-6, atol=1e-6)

    def test_head_300_below_the_rest(self):
        """The port's per-(i, h) max keeps a head 300 below the others
        finite in the backward too, equal to the jnp path's VJP."""
        q, k, v, bias, gate = core_inputs(1, 16, 128, 8, seed=16)
        bias[..., 0] -= 300.0
        dva = cotangent(q, 17)
        got = port_grads(q, k, v, bias, gate, dva)
        for g in got:
            assert np.isfinite(g).all()
        assert np.abs(got[3][..., 0]).max() > 1e-3   # the head still learns
        assert_grads_close(got, jax_grads(jnp_core, q, k, v, bias, gate, dva),
                           **TOL)

    def test_fully_masked_sample_has_finite_zero_grads(self):
        q, k, v, bias, gate = core_inputs(2, 8, 32, 4, seed=18)
        bias[0] = -1e9
        gate[0] = -1e9
        got = port_grads(q, k, v, bias, gate, cotangent(q, 19))
        for g in got:
            assert np.isfinite(g).all()
            assert np.all(g[0] == 0)
            assert np.abs(g[1]).max() > 0

    def test_backward_wrapper_checks_shapes_and_counts_no_cpu_launch(self):
        q, k, v, bias, gate = (_t(x) for x in core_inputs(1, 8, 32, 4,
                                                            seed=20))
        dva = torch.zeros_like(q)
        with pytest.raises(ValueError, match="dva"):
            triplet_dense_bwd(q, k, v, bias, gate, dva[:, :4])
        before = triplet_dense_bwd.launches
        got = triplet_dense_bwd(q, k, v, bias, gate, _t(cotangent(q, 21)))
        ref = triplet_dense_bwd_reference(q, k, v, bias, gate,
                                          _t(cotangent(q, 21)))
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
        assert triplet_dense_bwd.launches == before   # no kernel on the CPU


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


class TestTripletAttentionGradients:
    @pytest.mark.parametrize("use_pallas", ["dense", False])
    def test_dense_path_goes_through_the_autograd_function(self, use_pallas):
        mod = TripletAttention(32, 4)
        e = torch.randn(1, 6, 6, 32, generator=torch.Generator().manual_seed(0))
        out = mod(e, torch.zeros(1, 6, 6, 1), use_pallas=use_pallas)
        want = 2 if use_pallas == "dense" else 0   # the in and out directions
        assert _grad_nodes(out, "TripletDenseCoreBackward") == want

    @pytest.mark.parametrize("gated", [True, False])
    def test_param_grads_match_tgt_tpu(self, gated):
        """Every parameter's gradient on both paths against jax.grad of the
        jnp triplet attention, mapped through the weight bridge."""
        b, n, w, h = 2, 16, 64, 4
        p = triplet_attention_init(jax.random.PRNGKey(4), w, h, gated=gated)
        rs = np.random.RandomState(4)
        e = rs.randn(b, n, n, w).astype(np.float32) * 0.5
        ct = rs.randn(b, n, n, w).astype(np.float32)
        nm = np.ones((b, n), np.float32)
        nm[1, 11:] = 0
        mask = np.asarray(additive_mask_from_node_mask(jnp.asarray(nm)))
        jnp_fn = triplet_attention if gated else triplet_attention_ungated

        def loss(params):
            out = jnp_fn(params, jnp.asarray(e), jnp.asarray(mask),
                         num_heads=h)
            return jnp.sum(out * jnp.asarray(ct))

        ref = state_dict_from_jax_params(
            {"m": jax.tree.map(np.asarray, jax.grad(loss)(p))}, TGTConfig())
        ref = {k[2:]: v for k, v in ref.items()}
        # The ungated core's per-head bias (lin_E_*.bias) shifts every logit
        # of a softmax row alike, so its gradient is zero in exact
        # arithmetic and float noise on both sides: such a tensor is held
        # to 1e-4 of the module's largest gradient, the rest to 1e-4 of
        # their own.
        top = max(float(v.abs().max()) for v in ref.values())
        for use_pallas in ("dense", False):
            mod = TripletAttention(w, h, gated=gated)
            sd = state_dict_from_jax_params(
                {"m": jax.tree.map(np.asarray, p)}, TGTConfig())
            mod.load_state_dict({k[2:]: v for k, v in sd.items()})
            out = mod(_t(e), _t(mask), use_pallas=use_pallas)
            (out * _t(ct)).sum().backward()
            for name, param in mod.named_parameters():
                assert param.grad is not None, name
                scale = float(ref[name].abs().max())
                if scale > 1e-3 * top:
                    assert float(param.grad.abs().max()) > 0, name
                np.testing.assert_allclose(
                    param.grad.numpy(), ref[name].numpy(), rtol=1e-4,
                    atol=1e-4 * max(scale, 1e-3 * top),
                    err_msg=f"{name} use_pallas={use_pallas}")
