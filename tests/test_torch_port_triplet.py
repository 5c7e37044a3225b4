"""tgt_torch's triplet attention against tgt_tpu (CPU, float32).

1. The plain version of the kernel (``triplet_dense_fwd`` on CPU tensors)
   against tgt_tpu's dense Pallas core ``_dense_core`` in interpret mode and
   against the jnp einsum, at (W=128, H=8, N=16) and at (W=128, H=16, d=8,
   N=24), the latter a j-padded bucket on the JAX side. Both satisfy the
   JAX kernel's lane rule N*H % 128 == 0.
2. The port's gated and ungated ``TripletAttention`` against
   ``triplet_attention_dense(..., interpret=True)`` and against
   ``ops/triplet.triplet_attention`` at 1e-5.
3. A head whose bias sits 300 below the others: finite and equal to the jnp
   path (the TPU kernel's cross-head row max flushes that head to zero).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.core.graph import additive_mask_from_node_mask
from tgt_tpu.ops.pallas.triplet_dense import (_dense_core, _jpad,
                                              triplet_attention_dense)
from tgt_tpu.ops.triplet import (triplet_attention, triplet_attention_init,
                                 triplet_attention_ungated)
from tgt_torch.models.convert import state_dict_from_jax_params
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops.kernels.triplet_dense import (triplet_dense_fwd,
                                                 triplet_dense_fwd_reference)
from tgt_torch.ops.triplet import (TRIPLET_VARIANTS, AxialAttention,
                                   TriangularUpdate, TripletAggregate,
                                   TripletAttention, get_triplet_module)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def core_inputs(b, n, w, h, seed=0):
    """q (pre-scaled), k, v, bias and gate of one direction, with a padded
    sample (its masked pairs carry -1e9 in bias and gate)."""
    rs = np.random.RandomState(seed)
    d = w // h
    q = rs.randn(b, n, n, d, h).astype(np.float32) * d ** -0.5
    k = rs.randn(b, n, n, d, h).astype(np.float32)
    v = rs.randn(b, n, n, d, h).astype(np.float32)
    nm = np.ones((b, n), np.float32)
    nm[-1, n - 5:] = 0
    mask = np.asarray(additive_mask_from_node_mask(jnp.asarray(nm)))
    bias = rs.randn(b, n, n, h).astype(np.float32) + mask
    gate = rs.randn(b, n, n, h).astype(np.float32) + mask
    return q, k, v, bias, gate


def jnp_core(q, k, v, bias, gate):
    """The jnp path's core (tgt_tpu/ops/triplet.py:353-364), no lin_O."""
    s = (jnp.einsum("bijdh,bjkdh->bjhik", q, k)
         + jnp.transpose(bias, (0, 3, 1, 2))[:, None])
    a = jax.nn.softmax(s, axis=-1)
    if gate is not None:
        a = a * jax.nn.sigmoid(jnp.transpose(gate, (0, 3, 1, 2)))[:, None]
    return jnp.einsum("bjhik,bjkdh->bjidh", a, v)


def pallas_core(q, k, v, bias, gate):
    """tgt_tpu's dense Pallas core in interpret mode, j-padded as its public
    entry pads it."""
    n = q.shape[1]
    pj = _jpad(n) - n
    q = jnp.pad(q, ((0, 0), (0, 0), (0, pj), (0, 0), (0, 0)))
    k = jnp.pad(k, ((0, 0), (0, pj), (0, 0), (0, 0), (0, 0)))
    v = jnp.pad(v, ((0, 0), (0, pj), (0, 0), (0, 0), (0, 0)))
    va = _dense_core(q, k, v, bias, gate, None, gate is not None, True)
    return va[:, :n].reshape(q.shape[0], n, n, -1, q.shape[-1])


GEOMETRIES = [(2, 16, 128, 8), (2, 24, 128, 16)]   # (b, N, W, H)


class TestPlainCore:
    @pytest.mark.parametrize("gated", [True, False])
    @pytest.mark.parametrize("geom", GEOMETRIES, ids=["N16H8", "N24H16"])
    def test_plain_matches_pallas_and_jnp(self, geom, gated):
        q, k, v, bias, gate = core_inputs(*geom)
        gate = gate if gated else None
        jargs = [None if x is None else jnp.asarray(x)
                 for x in (q, k, v, bias, gate)]
        got = triplet_dense_fwd(*[None if x is None else _t(x)
                                  for x in (q, k, v, bias, gate)]).numpy()
        np.testing.assert_allclose(got, np.asarray(jnp_core(*jargs)), **TOL)
        np.testing.assert_allclose(got, np.asarray(pallas_core(*jargs)), **TOL)

    def test_strided_inputs_match(self):
        """The pair-transposed K/V views the out direction passes."""
        q, k, v, bias, gate = (_t(x) for x in core_inputs(2, 8, 32, 4, seed=1))
        got = triplet_dense_fwd(q, k.transpose(1, 2), v.transpose(1, 2), bias,
                                gate)
        ref = triplet_dense_fwd(q, k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous(), bias, gate)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)

    def test_bf16_returns_input_dtype(self):
        q, k, v, bias, gate = (_t(x) for x in core_inputs(1, 8, 32, 4, seed=2))
        ref = triplet_dense_fwd(q, k, v, bias, gate)
        got = triplet_dense_fwd(*(x.to(torch.bfloat16)
                                  for x in (q, k, v, bias, gate)))
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), ref, rtol=0,
                                   atol=2e-2 * float(ref.abs().max()))

    def test_fully_masked_sample_is_finite_and_zero_when_gated(self):
        q, k, v, bias, gate = (_t(x) for x in core_inputs(2, 8, 32, 4, seed=3))
        bias[0] = -1e9
        gate[0] = -1e9
        out = triplet_dense_fwd(q, k, v, bias, gate)
        assert torch.isfinite(out).all()
        assert torch.all(out[0] == 0)

    def test_wrapper_rejects_bad_inputs(self):
        q, k, v, bias, gate = (_t(x) for x in core_inputs(1, 8, 32, 4, seed=4))
        with pytest.raises(ValueError, match="shape"):
            triplet_dense_fwd(q, k[:, :4], v, bias, gate)
        with pytest.raises(TypeError):
            triplet_dense_fwd(q, k.double(), v, bias, gate)
        with pytest.raises(ValueError, match="cpu or cuda"):
            triplet_dense_fwd(*(x.to("meta") for x in (q, k, v, bias, gate)))

    def test_plain_version_is_the_cpu_path(self):
        q, k, v, bias, gate = (_t(x) for x in core_inputs(1, 8, 32, 4, seed=5))
        before = triplet_dense_fwd.launches
        torch.testing.assert_close(triplet_dense_fwd(q, k, v, bias, gate),
                                   triplet_dense_fwd_reference(q, k, v, bias,
                                                               gate),
                                   rtol=0, atol=0)
        assert triplet_dense_fwd.launches == before   # no kernel on the CPU


def load_triplet(p, w, h, gated):
    mod = TripletAttention(w, h, gated=gated)
    sd = state_dict_from_jax_params({"m": p}, TGTConfig())
    mod.load_state_dict({k[2:]: v for k, v in sd.items()})
    return mod.requires_grad_(False)


class TestTripletAttention:
    @pytest.mark.parametrize("use_pallas", ["dense", False])
    @pytest.mark.parametrize("gated", [True, False])
    def test_matches_dense_kernel_and_jnp(self, gated, use_pallas):
        b, n, w, h = 2, 16, 128, 8
        p = triplet_attention_init(jax.random.PRNGKey(3), w, h, gated=gated)
        rs = np.random.RandomState(3)
        e = rs.randn(b, n, n, w).astype(np.float32) * 0.5
        nm = np.ones((b, n), np.float32)
        nm[1, 11:] = 0
        mask = np.asarray(additive_mask_from_node_mask(jnp.asarray(nm)))
        jnp_fn = triplet_attention if gated else triplet_attention_ungated
        ref = np.asarray(jnp_fn(p, jnp.asarray(e), jnp.asarray(mask),
                                num_heads=h))
        dense = np.asarray(triplet_attention_dense(
            p, jnp.asarray(e), jnp.asarray(mask), num_heads=h, gated=gated,
            interpret=True))
        got = load_triplet(p, w, h, gated)(_t(e), _t(mask),
                                           use_pallas=use_pallas).numpy()
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, dense, **TOL)

    def test_head_300_below_the_rest(self):
        """Head 0's bias 300 below the others: the port keeps a per-(i, h)
        max, stays finite and equals the jnp path; the TPU kernel's
        cross-head row max flushes that head to zero."""
        b, n, w, h = 1, 16, 128, 8
        p = triplet_attention_init(jax.random.PRNGKey(0), w, h, gated=True)
        p["lin_EG_in"]["b"] = p["lin_EG_in"]["b"].at[0].set(-300.0)
        e = np.random.RandomState(1).randn(b, n, n, w).astype(np.float32) * 0.1
        mask = np.zeros((b, n, n, 1), np.float32)
        ref = np.asarray(triplet_attention(p, jnp.asarray(e),
                                           jnp.asarray(mask), num_heads=h))
        got = load_triplet(p, w, h, True)(_t(e), _t(mask),
                                          use_pallas="dense").numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, **TOL)

        q, k, v, bias, gate = core_inputs(b, n, w, h, seed=6)
        bias[..., 0] -= 300.0
        port = triplet_dense_fwd(*(_t(x) for x in (q, k, v, bias, gate)))
        tpu = np.asarray(pallas_core(*(jnp.asarray(x)
                                       for x in (q, k, v, bias, gate))))
        np.testing.assert_allclose(port.numpy(), np.asarray(jnp_core(
            *(jnp.asarray(x) for x in (q, k, v, bias, gate)))), **TOL)
        assert np.abs(port.numpy()[..., 0]).max() > 0.1
        assert np.all(tpu[..., 0] == 0)          # the fault the port drops

    def test_unported_options_raise(self):
        """The two options that once raised NotImplementedError, the legacy
        fused pair (``use_pallas=True``) and triplet dropout in training,
        now run: test_torch_port_legacy.py and test_torch_port_dropout.py
        hold them against tgt_tpu."""
        mod = TripletAttention(32, 4)
        e = torch.randn(1, 4, 4, 32, generator=torch.Generator().manual_seed(0))
        mask = torch.zeros(1, 4, 4, 1)
        ref = mod(e, mask)
        torch.testing.assert_close(mod(e, mask, use_pallas=True), ref,
                                   rtol=1e-5, atol=1e-6)
        for use_pallas in ("dense", False):
            out = mod(e, mask, attention_dropout=0.1, deterministic=False,
                      generator=torch.Generator().manual_seed(1),
                      use_pallas=use_pallas)
            assert out.shape == ref.shape and torch.isfinite(out).all()
            assert not torch.allclose(out, ref)


class TestRegistry:
    def test_all_six_names_and_the_typo(self):
        assert len(TRIPLET_VARIANTS) == 6
        assert get_triplet_module("attention")(32, 4).gated
        assert not get_triplet_module("attention_ungated")(32, 4).gated
        for name, cls in (("aggregate", TripletAggregate),
                          ("aggregate_ungated", TripletAggregate),
                          ("triangular_update", TriangularUpdate),
                          ("tiangular_update", TriangularUpdate),
                          ("axial_attention", AxialAttention)):
            mod = get_triplet_module(name)(32, 4)
            assert type(mod) is cls
            assert getattr(mod, "gated", True) == (name != "aggregate_ungated")
        with pytest.raises(ValueError, match="invalid"):
            get_triplet_module("bogus")

    @pytest.mark.parametrize("gated", [True, False])
    def test_state_dict_names(self, gated):
        bias = "lin_EG" if gated else "lin_E"
        names = set(TripletAttention(32, 4, gated=gated).state_dict())
        assert names == {f"{m}.{t}" for m in (
            "tri_ln_e", "lin_QKV_in", f"{bias}_in", "lin_QKV_out",
            f"{bias}_out", "lin_O") for t in ("weight", "bias")}
