"""tgt_torch's primitives and layers against tgt_tpu on the same weights and
inputs (CPU, float32, atol/rtol 1e-5).

Weights are made by tgt_tpu's initialisers and carried into the port's
modules through the weight bridge; inputs are made with numpy from a seed.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.models.embedding import embed_input_apply, embed_input_init
from tgt_tpu.models.model_config import TGTConfig as JaxTGTConfig
from tgt_tpu.ops import activations as jact
from tgt_tpu.ops import common as jcommon
from tgt_tpu.ops.attention import (edge_update, edge_update_init,
                                   egt_attention, egt_attention_init)
from tgt_tpu.ops.embed3d import (fourier3d_embed, fourier3d_init,
                                 gaussian3d_embed, gaussian3d_init)
from tgt_tpu.ops.ffn import ffn, ffn_init
from tgt_torch.models.convert import state_dict_from_jax_params
from tgt_torch.models.embedding import EmbedInput
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops import common
from tgt_torch.ops.activations import get_activation
from tgt_torch.ops.attention import EdgeUpdate, EGTAttention
from tgt_torch.ops.embed3d import Fourier3DEmbed, Gaussian3DEmbed
from tgt_torch.ops.ffn import FFN

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def load_module(module, params, prefix="m"):
    """Load a tgt_tpu params dict into a port module via the weight bridge
    (strict: every name must match)."""
    sd = state_dict_from_jax_params({prefix: params}, TGTConfig())
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()})
    return module.requires_grad_(False)


def load_m3d(module, params):
    sd = state_dict_from_jax_params({"input_embed": {"m3d_embed": params}},
                                    TGTConfig())
    pre = "input_embed.m3d_embed."
    module.load_state_dict({k[len(pre):]: v for k, v in sd.items()})
    return module.requires_grad_(False)


def pair_mask(rs, b, n):
    """A (b, N) node mask with a padded sample, and its additive pair mask
    of -1e9 as tgt_tpu builds it."""
    nm = np.ones((b, n), np.float32)
    nm[-1, n - 3:] = 0
    em = nm[:, :, None] * nm[:, None, :]
    return nm, ((1.0 - em) * -1e9)[..., None].astype(np.float32)


class TestPrimitives:
    def test_linear(self):
        rs = np.random.RandomState(0)
        p = jcommon.linear_init(jax.random.PRNGKey(0), 12, 7)
        x = rs.randn(3, 5, 12).astype(np.float32)
        lin = load_module(torch.nn.Linear(12, 7), p)
        np.testing.assert_allclose(common.linear(lin, _t(x)).numpy(),
                                   _np(jcommon.linear(p, jnp.asarray(x))), **TOL)

    def test_linear_casts_weight_to_input_dtype(self):
        lin = torch.nn.Linear(4, 3)
        y = common.linear(lin, torch.ones(2, 4, dtype=torch.bfloat16))
        assert y.dtype == torch.bfloat16
        assert lin.weight.dtype == torch.float32

    def test_layernorm(self):
        rs = np.random.RandomState(1)
        p = {"scale": rs.randn(16).astype(np.float32),
             "bias": rs.randn(16).astype(np.float32)}
        x = (rs.randn(4, 6, 16) * 3 + 1).astype(np.float32)
        ln = load_module(torch.nn.LayerNorm(16), p)
        np.testing.assert_allclose(common.layernorm(ln, _t(x)).numpy(),
                                   _np(jcommon.layernorm(p, jnp.asarray(x))),
                                   **TOL)

    def test_layernorm_computes_in_f32(self):
        ln = torch.nn.LayerNorm(8).requires_grad_(False)
        x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
        y = common.layernorm(ln, x.to(torch.bfloat16))
        assert y.dtype == torch.bfloat16
        ref = common.layernorm(ln, x.to(torch.bfloat16).float())
        np.testing.assert_allclose(y.float().numpy(), ref.to(torch.bfloat16)
                                   .float().numpy(), rtol=0, atol=0)

    def test_embedding_clamps_out_of_range_ids(self):
        p = jcommon.embedding_init(jax.random.PRNGKey(2), 10, 4, padding_idx=0)
        ids = np.array([[-3, 0, 4, 9, 10, 57]])
        emb = load_module(torch.nn.Embedding(10, 4), p)
        got = common.embedding(emb, _t(ids)).numpy()
        np.testing.assert_allclose(got, _np(jcommon.embedding(
            p, jnp.asarray(ids))), **TOL)
        np.testing.assert_array_equal(got[0, 4], got[0, 3])   # clipped high
        np.testing.assert_array_equal(got[0, 0], np.zeros(4))  # clipped low

    @pytest.mark.parametrize("name", ["gelu", "geglu", "glu", "swiglu", "relu",
                                      "silu", "elu", "leaky_relu", "sigmoid",
                                      "tanh", "softplus", "mish", "hardswish"])
    def test_activation(self, name):
        x = np.random.RandomState(3).randn(5, 8).astype(np.float32) * 3
        fn, mul = get_activation(name)
        jfn, jmul = jact.get_activation(name)
        assert mul == jmul
        np.testing.assert_allclose(fn(_t(x)).numpy(),
                                   _np(jfn(jnp.asarray(x))), **TOL)

    def test_dropout_and_drop_path_follow_generator(self):
        x = torch.ones(64, 32)

        def draw(fn, seed):
            return fn(x, 0.25, False, torch.Generator().manual_seed(seed))

        for fn in (common.dropout, common.drop_path):
            a, b, c = draw(fn, 1), draw(fn, 1), draw(fn, 2)
            torch.testing.assert_close(a, b, rtol=0, atol=0)
            assert not torch.equal(a, c)
            assert set(torch.unique(a).tolist()) <= {0.0, float(
                torch.tensor(1.0 / 0.75))}
            assert fn(x, 0.25, True, None) is x       # deterministic
            assert fn(x, 0.0, False, None) is x       # rate 0
        # drop_path keeps or drops whole samples
        dp = draw(common.drop_path, 3)
        assert all(len(torch.unique(row)) == 1 for row in dp)


class TestFFN:
    @pytest.mark.parametrize("activation,mult", [("gelu", 1.0),
                                                 ("geglu", 1.5)])
    def test_ffn(self, activation, mult):
        p = ffn_init(jax.random.PRNGKey(4), 24, mult, activation)
        x = np.random.RandomState(4).randn(2, 5, 24).astype(np.float32)
        mod = load_module(FFN(24, mult, activation), p)
        np.testing.assert_allclose(
            mod(_t(x)).numpy(),
            _np(ffn(p, jnp.asarray(x), activation=activation)), **TOL)


class TestEmbed3D:
    def test_gaussian(self):
        rs = np.random.RandomState(5)
        p = gaussian3d_init(jax.random.PRNGKey(5), 32, 257, 16)
        # non-trivial mul/bias so the per-type affine is exercised
        p["mul"]["w"] = jnp.asarray(rs.randn(257, 1).astype(np.float32))
        p["bias"]["w"] = jnp.asarray(rs.randn(257, 1).astype(np.float32))
        dist = (rs.rand(2, 6, 6) * 5).astype(np.float32)
        types = rs.randint(0, 300, size=(2, 6, 6, 2))   # some out of range
        mod = load_m3d(Gaussian3DEmbed(32, 257, 16), p)
        np.testing.assert_allclose(
            mod(_t(dist), _t(types)).numpy(),
            _np(gaussian3d_embed(p, jnp.asarray(dist), jnp.asarray(types))),
            **TOL)

    def test_gaussian_init_keeps_reference_quirks(self):
        mod = Gaussian3DEmbed(8, 257, 16)
        common.init_module_(mod, torch.Generator().manual_seed(0))
        assert torch.all(mod.gbf.mul.weight == 1.0)       # row 0 too
        assert torch.all(mod.gbf.bias.weight == 0.0)
        assert 0.0 <= mod.gbf.means.weight.min() <= mod.gbf.means.weight.max() <= 3.0

    def test_fourier(self):
        p = fourier3d_init(jax.random.PRNGKey(6), 32, 16)
        dist = (np.random.RandomState(6).rand(2, 6, 6) * 5).astype(np.float32)
        mod = load_m3d(Fourier3DEmbed(32, 16), p)
        np.testing.assert_allclose(
            mod(_t(dist)).numpy(),
            _np(fourier3d_embed(p, jnp.asarray(dist))), **TOL)
        # the buffer the port computes itself matches tgt_tpu's
        np.testing.assert_allclose(Fourier3DEmbed(32, 16).angular_freqs.numpy(),
                                   _np(p["angular_freqs"]), rtol=1e-6)


def embed_batch(rs, b, n):
    """Raw model inputs with padding, out-of-range hops and 3D distances."""
    nm, _ = pair_mask(rs, b, n)
    nodef = np.stack([rs.randint(1, 40, size=(b, n)) + k * 128
                      for k in range(9)], axis=-1) * nm[..., None].astype(int)
    featm = np.stack([rs.randint(1, 8, size=(b, n, n)) + k * 8
                      for k in range(3)], axis=-1)
    coords = rs.randn(b, n, 3).astype(np.float32) * 2
    return {
        "node_features": nodef.astype(np.int16),
        "distance_matrix": rs.randint(0, 600, size=(b, n, n)).astype(np.int16),
        "feature_matrix": featm.astype(np.int16),
        "node_mask": nm,
        "edge_mask": nm[:, :, None] * nm[:, None, :],
        "dist_input": np.linalg.norm(coords[:, :, None] - coords[:, None],
                                     axis=-1).astype(np.float32),
    }


class TestEmbedInput:
    @pytest.mark.parametrize("kind", ["gaussian", "fourier", "none"])
    def test_embed_input(self, kind):
        kw = dict(node_width=16, edge_width=24, upto_hop=8, embed_3d_type=kind,
                  num_3d_kernels=16)
        jcfg, cfg = JaxTGTConfig(**kw), TGTConfig(**kw)
        p = embed_input_init(jax.random.PRNGKey(7), jcfg)
        batch = embed_batch(np.random.RandomState(7), 2, 7)
        ref = embed_input_apply(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                jcfg)
        sd = state_dict_from_jax_params({"input_embed": p}, cfg)
        mod = EmbedInput(cfg).requires_grad_(False)
        mod.load_state_dict({k[len("input_embed."):]: v for k, v in sd.items()})
        got = mod({k: _t(v) for k, v in batch.items()})
        for name in ("h", "e", "mask"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       _np(getattr(ref, name)), **TOL,
                                       err_msg=name)


class TestEGTAttention:
    @pytest.mark.parametrize("edge_upd,scale_degree", [(True, True),
                                                       (False, False)])
    def test_egt_attention(self, edge_upd, scale_degree):
        rs = np.random.RandomState(8)
        b, n, wn, we, heads = 2, 7, 32, 16, 4
        p = egt_attention_init(jax.random.PRNGKey(8), wn, we, heads,
                               edge_update=edge_upd)
        h = rs.randn(b, n, wn).astype(np.float32)
        e = rs.randn(b, n, n, we).astype(np.float32)
        _, mask = pair_mask(rs, b, n)
        jh, je = egt_attention(p, jnp.asarray(h), jnp.asarray(e),
                               jnp.asarray(mask), num_heads=heads,
                               scale_degree=scale_degree, edge_update=edge_upd)
        mod = load_module(EGTAttention(wn, we, heads, edge_update=edge_upd), p)
        th, te = mod(_t(h), _t(e), _t(mask), scale_degree=scale_degree)
        np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
        if edge_upd:
            np.testing.assert_allclose(te.numpy(), _np(je), **TOL)
        else:
            assert te is None and je is None

    def test_source_dropout_masks_whole_source_columns(self):
        b, n, wn, we, heads = 2, 6, 16, 8, 4
        mod = EGTAttention(wn, we, heads).requires_grad_(False)
        common.init_module_(mod, torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(0)
        h, e = torch.randn(b, n, wn, generator=g), torch.randn(b, n, n, we, generator=g)
        mask = torch.zeros(b, n, n, 1)
        kw = dict(source_dropout=0.5, deterministic=False)
        a = mod(h, e, mask, generator=torch.Generator().manual_seed(5), **kw)
        a2 = mod(h, e, mask, generator=torch.Generator().manual_seed(5), **kw)
        torch.testing.assert_close(a[0], a2[0], rtol=0, atol=0)
        assert torch.isfinite(a[0]).all()

    def test_edge_update(self):
        rs = np.random.RandomState(9)
        b, n, wn, we, heads = 2, 7, 32, 16, 4
        p = edge_update_init(jax.random.PRNGKey(9), wn, we, heads)
        h = rs.randn(b, n, wn).astype(np.float32)
        e = rs.randn(b, n, n, we).astype(np.float32)
        _, mask = pair_mask(rs, b, n)
        jh, je = edge_update(p, jnp.asarray(h), jnp.asarray(e),
                             jnp.asarray(mask), num_heads=heads)
        th, te = load_module(EdgeUpdate(wn, we, heads), p)(_t(h), _t(e),
                                                           _t(mask))
        np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
        np.testing.assert_allclose(te.numpy(), _np(je), **TOL)
