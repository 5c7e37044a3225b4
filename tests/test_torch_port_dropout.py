"""tgt_torch's in-kernel triplet dropout against tgt_tpu (CPU, float32).

1. ``hash_keep`` equals ``_hash_keepf`` bit for bit over 2**17 indices, and
   ``keep_tile`` equals ``_keep_tile``.
2. The plain dense core at rate 0.3 (``triplet_dense`` on CPU tensors:
   ``TripletDenseCore`` over the plain forward and backward) against
   tgt_tpu's ``_dense_core`` with the same seeds in interpret mode, j-padded
   as its public entry pads it, gated and ungated: the forward within 1e-5
   of max|ref|, all five gradients against ``jax.vjp`` within 2e-5 of each
   max|ref| (the bound of ``tests/test_pallas.py``); the out direction's
   pair-transposed K/V views; the plain backward against autograd.
3. ``TripletAttention(use_pallas='dense')`` with dropout against tgt_tpu's
   ``triplet_attention(..., use_pallas='dense')``, both sides drawing the
   port's per-direction seeds, with a padded node: output and every
   parameter's and the input's gradient.
4. The routing: deterministic and rate 0 draw no seed; the plain path
   drops out with PyTorch's generator; the wrappers' checks.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.core.graph import additive_mask_from_node_mask
from tgt_tpu.ops.pallas.triplet_dense import (_dense_core, _hash_keepf, _jpad,
                                              _keep_tile)
from tgt_tpu.ops.triplet import triplet_attention, triplet_attention_init
from tgt_tpu.ops.triplet import triplet_attention_ungated
from tgt_torch.models.convert import state_dict_from_jax_params
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops.kernels.triplet_dense import (
    dropout_constants, hash_keep, keep_tile, triplet_dense, triplet_dense_bwd,
    triplet_dense_bwd_reference, triplet_dense_fwd,
    triplet_dense_fwd_reference)
from tgt_torch.ops.triplet import TripletAttention, dropout_seeds

from test_torch_port_triplet import GEOMETRIES, core_inputs

torch.set_num_threads(1)

RATE = 0.3


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def seeds_for(b, seed):
    return np.random.RandomState(seed).randint(
        0, 2 ** 31 - 1, size=(b, 1)).astype(np.int32)


def pallas_core(q, k, v, bias, gate, seed):
    """tgt_tpu's dense Pallas core at RATE in interpret mode, j-padded as
    its public entry pads it (the hash index keeps the true n)."""
    n = q.shape[1]
    pj = _jpad(n) - n
    q = jnp.pad(q, ((0, 0), (0, 0), (0, pj), (0, 0), (0, 0)))
    k = jnp.pad(k, ((0, 0), (0, pj), (0, 0), (0, 0), (0, 0)))
    v = jnp.pad(v, ((0, 0), (0, pj), (0, 0), (0, 0), (0, 0)))
    va = _dense_core(q, k, v, bias, gate, seed, gate is not None, True, RATE)
    return va[:, :n].reshape(q.shape[0], n, n, -1, q.shape[-1])


def jax_grads(q, k, v, bias, gate, seed, dva):
    """Output and the five gradients of ``pallas_core`` by ``jax.vjp``."""
    seed = jnp.asarray(seed)
    if gate is None:
        out, vjp = jax.vjp(lambda *a: pallas_core(*a, None, seed),
                           *(jnp.asarray(x) for x in (q, k, v, bias)))
        return out, list(vjp(jnp.asarray(dva))) + [None]
    out, vjp = jax.vjp(lambda *a: pallas_core(*a, seed),
                       *(jnp.asarray(x) for x in (q, k, v, bias, gate)))
    return out, list(vjp(jnp.asarray(dva)))


def port_grads(q, k, v, bias, gate, seed, dva):
    """Output and the five gradients of ``triplet_dense`` at RATE."""
    leaves = [None if x is None else _t(x, grad=True)
              for x in (q, k, v, bias, gate)]
    out = triplet_dense(*leaves, seed=torch.from_numpy(seed), rate=RATE)
    out.backward(_t(dva))
    return out.detach().numpy(), [None if x is None else x.grad.numpy()
                                  for x in leaves]


def assert_scaled_close(got, want, atol, name=""):
    """|got - want| <= atol * max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol,
                               err_msg=name)


class TestHash:
    @pytest.mark.parametrize("seed", [1234, 2 ** 31 - 2])
    def test_hash_keep_equals_hash_keepf_bit_for_bit(self, seed):
        lin = np.arange(1 << 17, dtype=np.int32)
        want = np.asarray(_hash_keepf(jnp.asarray(lin), jnp.int32(seed), RATE))
        got = hash_keep(torch.from_numpy(lin), seed, RATE).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert abs((got > 0).mean() - (1 - RATE)) < 0.01

    def test_keep_tile_and_seed_tensor(self):
        want = np.asarray(_keep_tile(jnp.int32(77), 5, 24, 24 * 16, RATE))
        got = keep_tile(torch.tensor(77, dtype=torch.int32), 5, 24, 24 * 16,
                        RATE).numpy()
        np.testing.assert_array_equal(got, want)

    def test_constants(self):
        thresh, scale = dropout_constants(RATE)
        assert thresh == int(0.7 * 2.0 ** 31)
        assert np.float32(scale) == np.float32(1.0 / 0.7)
        assert dropout_constants(0.0)[0] == 0x7FFFFFFF


class TestPlainCoreDropout:
    @pytest.mark.parametrize("gated", [True, False])
    @pytest.mark.parametrize("geom", GEOMETRIES, ids=["N16H8", "N24H16"])
    def test_matches_pallas_forward_and_vjp(self, geom, gated):
        q, k, v, bias, gate = core_inputs(*geom, seed=30)
        gate = gate if gated else None
        seed = seeds_for(geom[0], 31)
        dva = np.random.RandomState(32).randn(*q.shape).astype(np.float32)
        want_out, want = jax_grads(q, k, v, bias, gate, seed, dva)
        got_out, got = port_grads(q, k, v, bias, gate, seed, dva)
        assert_scaled_close(got_out, want_out, 1e-5, "va")
        for name, g, w in zip(("dq", "dk", "dv", "dbias", "dgate"), got,
                              want):
            if w is None:
                assert g is None, name
                continue
            assert_scaled_close(g, w, 2e-5, name)

    def test_out_direction_views(self):
        """The out direction hands the core pair-transposed K/V views; the
        mask index stays in the core's (j, i, k, h) frame."""
        q, k, v, bias, gate = core_inputs(2, 16, 128, 8, seed=33)
        kt, vt = k.transpose(0, 2, 1, 3, 4), v.transpose(0, 2, 1, 3, 4)
        seed = seeds_for(2, 34)
        dva = np.random.RandomState(35).randn(*q.shape).astype(np.float32)
        want_out, want = jax_grads(q, kt, vt, bias, gate, seed, dva)
        leaves = [_t(x, grad=True) for x in (q, k, v, bias, gate)]
        out = triplet_dense(leaves[0], leaves[1].transpose(1, 2),
                            leaves[2].transpose(1, 2), *leaves[3:],
                            seed=torch.from_numpy(seed), rate=RATE)
        out.backward(_t(dva))
        assert_scaled_close(out.detach().numpy(), want_out, 1e-5, "va")
        got = [x.grad.numpy() for x in leaves]
        got[1], got[2] = (g.transpose(0, 2, 1, 3, 4) for g in got[1:3])
        for name, g, w in zip(("dq", "dk", "dv", "dbias", "dgate"), got,
                              want):
            assert_scaled_close(g, w, 2e-5, name)

    @pytest.mark.parametrize("gated", [True, False])
    def test_plain_backward_matches_autograd(self, gated):
        q, k, v, bias, gate = core_inputs(2, 8, 32, 4, seed=36)
        gate = gate if gated else None
        seed = torch.from_numpy(seeds_for(2, 37))
        dva = _t(np.random.RandomState(38).randn(*q.shape))
        leaves = [None if x is None else _t(x, grad=True)
                  for x in (q, k, v, bias, gate)]
        out = triplet_dense_fwd_reference(*leaves, seed, RATE)
        want = torch.autograd.grad(out, [x for x in leaves if x is not None],
                                   dva)
        got = triplet_dense_bwd_reference(
            *(None if x is None else x.detach() for x in leaves), dva, seed,
            RATE)
        assert (got[4] is None) == (not gated)
        for g, w in zip([x for x in got if x is not None], want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)

    def test_mask_drops_and_seed_matters(self):
        q, k, v, bias, gate = (_t(x) for x in core_inputs(2, 8, 32, 4,
                                                          seed=39))
        s1 = torch.tensor([[5], [6]], dtype=torch.int32)
        out0 = triplet_dense_fwd(q, k, v, bias, gate)
        out1 = triplet_dense_fwd(q, k, v, bias, gate, s1, RATE)
        out2 = triplet_dense_fwd(q, k, v, bias, gate, s1 + 7, RATE)
        assert not torch.allclose(out1, out0)
        assert not torch.allclose(out1, out2)
        # the seed is read only at rate > 0
        torch.testing.assert_close(triplet_dense_fwd(q, k, v, bias, gate, s1,
                                                     0.0), out0, rtol=0,
                                   atol=0)

    def test_wrappers_check_seed_and_rate_and_count_no_cpu_launch(self):
        q, k, v, bias, gate = (_t(x) for x in core_inputs(2, 8, 32, 4,
                                                          seed=40))
        with pytest.raises(ValueError, match="seed"):
            triplet_dense_fwd(q, k, v, bias, gate, None, RATE)
        with pytest.raises(ValueError, match="seed"):
            triplet_dense_fwd(q, k, v, bias, gate,
                              torch.zeros(3, 1, dtype=torch.int32), RATE)
        with pytest.raises(TypeError, match="int32"):
            triplet_dense_fwd(q, k, v, bias, gate,
                              torch.zeros(2, 1, dtype=torch.int64), RATE)
        with pytest.raises(ValueError, match="rate"):
            triplet_dense_fwd(q, k, v, bias, gate,
                              torch.zeros(2, 1, dtype=torch.int32), 1.0)
        seed = torch.zeros(2, 1, dtype=torch.int32)
        before = (triplet_dense_fwd.dropout_launches,
                  triplet_dense_bwd.dropout_launches)
        triplet_dense_bwd(q, k, v, bias, gate, torch.ones_like(q), seed, RATE)
        triplet_dense_fwd(q, k, v, bias, gate, seed, RATE)
        assert (triplet_dense_fwd.dropout_launches,
                triplet_dense_bwd.dropout_launches) == before


def load_triplet(p, w, h, gated):
    mod = TripletAttention(w, h, gated=gated)
    sd = state_dict_from_jax_params({"m": jax.tree.map(np.asarray, p)},
                                    TGTConfig())
    mod.load_state_dict({k[2:]: v for k, v in sd.items()})
    return mod


def graph_inputs(b, n, w, seed):
    rs = np.random.RandomState(seed)
    e = rs.randn(b, n, n, w).astype(np.float32) * 0.5
    nm = np.ones((b, n), np.float32)
    nm[1, n - 3:] = 0
    mask = np.array(additive_mask_from_node_mask(jnp.asarray(nm)))
    return e, mask


class TestTripletAttentionDropout:
    @pytest.mark.parametrize("gated", [True, False])
    @pytest.mark.parametrize("n,h", [(16, 8), (24, 16)])
    def test_dense_matches_tgt_tpu_with_injected_seeds(self, monkeypatch, n,
                                                        h, gated):
        """Both sides draw the port's seeds: tgt_tpu's per-direction
        ``jax.random.randint`` is replaced by the seeds that
        ``dropout_seeds`` draws from the layer's generator, in then out."""
        b, w = 2, 128
        p = triplet_attention_init(jax.random.PRNGKey(5), w, h, gated=gated)
        e, mask = graph_inputs(b, n, w, 6)
        ct = np.random.RandomState(7).randn(b, n, n, w).astype(np.float32)
        want_seeds = dropout_seeds(b, torch.Generator().manual_seed(8), "cpu")
        queue = [jnp.asarray(want_seeds[w_].numpy()) for w_ in ("in", "out")]
        drawn = []

        def injected(key, shape, minval, maxval, dtype):
            assert (shape, minval, maxval) == ((b, 1), 0, 2 ** 31 - 1)
            drawn.append(queue[len(drawn) % 2])
            return drawn[-1]

        monkeypatch.setattr(jax.random, "randint", injected)
        jnp_fn = triplet_attention if gated else triplet_attention_ungated

        def loss(params, ee):
            out = jnp_fn(params, ee, jnp.asarray(mask), num_heads=h,
                         attention_dropout=RATE, deterministic=False,
                         rng=jax.random.PRNGKey(0), use_pallas="dense")
            return jnp.sum(out * jnp.asarray(ct)), out

        (_, want), (jgrads, jge) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(e))
        assert len(drawn) == 2
        mod = load_triplet(p, w, h, gated)
        et = _t(e, grad=True)
        got = mod(et, _t(mask), attention_dropout=RATE, deterministic=False,
                  generator=torch.Generator().manual_seed(8),
                  use_pallas="dense")
        assert_scaled_close(got.detach().numpy(), np.asarray(want), 1e-5,
                            "out")
        (got * _t(ct)).sum().backward()
        assert_scaled_close(et.grad.numpy(), np.asarray(jge), 2e-5, "de")
        ref = state_dict_from_jax_params(
            {"m": jax.tree.map(np.asarray, jgrads)}, TGTConfig())
        top = max(float(v.abs().max()) for v in ref.values())
        for name, param in mod.named_parameters():
            # a tensor that only shifts whole softmax rows (lin_E_*.bias)
            # has a zero gradient in exact arithmetic, float noise on both
            # sides: held to 2e-5 of the module's largest gradient
            want_g = ref["m." + name].numpy()
            scale = np.abs(want_g).max()
            np.testing.assert_allclose(
                param.grad.numpy(), want_g, rtol=0,
                atol=2e-5 * (scale if scale > 1e-3 * top else top),
                err_msg=name)

    def test_deterministic_and_rate_zero_draw_no_seed(self):
        b, n, w, h = 2, 8, 32, 4
        mod = TripletAttention(w, h)
        e, mask = (torch.from_numpy(x) for x in graph_inputs(b, n, w, 9))
        ref = mod(e, mask, use_pallas="dense")
        for kw in (dict(attention_dropout=RATE, deterministic=True),
                   dict(attention_dropout=0.0, deterministic=False)):
            gen = torch.Generator().manual_seed(1)
            state = gen.get_state()
            out = mod(e, mask, generator=gen, use_pallas="dense", **kw)
            torch.testing.assert_close(out, ref, rtol=0, atol=0)
            assert torch.equal(gen.get_state(), state)

    def test_dense_draws_from_the_generator_and_each_seed_differs(self):
        b, n, w, h = 2, 8, 32, 4
        mod = TripletAttention(w, h)
        e, mask = (torch.from_numpy(x) for x in graph_inputs(b, n, w, 10))
        outs = [mod(e, mask, attention_dropout=RATE, deterministic=False,
                    generator=torch.Generator().manual_seed(s),
                    use_pallas="dense") for s in (1, 1, 2)]
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
        assert not torch.allclose(outs[0], outs[2])
        assert not torch.allclose(outs[0], mod(e, mask, use_pallas="dense"))

    def test_plain_path_drops_with_the_generator(self):
        """``use_pallas=False`` drops the (b, j, h, i, k) weights with
        PyTorch's dropout: reproducible from the generator, a different
        draw from the dense path's hash."""
        b, n, w, h = 2, 8, 32, 4
        mod = TripletAttention(w, h)
        e, mask = (torch.from_numpy(x) for x in graph_inputs(b, n, w, 11))

        def run(use_pallas, s=3):
            return mod(e, mask, attention_dropout=RATE, deterministic=False,
                       generator=torch.Generator().manual_seed(s),
                       use_pallas=use_pallas)

        plain = run(False)
        assert torch.isfinite(plain).all()
        torch.testing.assert_close(plain, run(False), rtol=0, atol=0)
        assert not torch.allclose(plain, run(False, 4))
        assert not torch.allclose(plain, run("dense"))
        assert not torch.allclose(plain, mod(e, mask))
