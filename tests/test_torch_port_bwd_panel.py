"""The bf16 backward body shared by the dense and the legacy triplet core
(``tgt_torch/csrc/triplet_bwd_mma.cuh``) and what surrounds it, on the CPU.

1. The plain dense backward in bf16 against ``jax.vjp`` of tgt_tpu's
   ``_dense_core`` in interpret mode, in bf16, on the same numpy inputs: the
   plain version rounds ds and the weights a to bf16 before the dQ, dK and dV
   products, as ``_dot``/``_dot_t`` do.
2. The dense wrapper's relayout to head-major and back: the inverse pair on
   the pair-transposed K/V views, a head padded to 16 with zeros.
3. The body's plain version ``panel_bwd_reference`` on relayouted dense
   inputs gives ``triplet_dense_bwd_reference``'s outputs, at rate 0 and at
   rate 0.3 with ``dropout_mask`` taken in the head-major frame; on the
   legacy inputs it gives ``triplet_core_bwd_reference``'s, in f32 exactly
   the same formulas, and in bf16 with the legacy instantiation's split of
   the weights (``split_dv``) within one bf16 step: dv takes tgt_tpu's f32
   weights to about 2^-16.
4. ``j_chunks`` covers every row j once and fills at most one wave.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_torch.ops.kernels.triplet_attention import (UNGATED_GATE,
                                                     triplet_core_bwd_reference)
from tgt_torch.ops.kernels.triplet_bwd_panel import (BLOCKS_PER_SM, j_chunks,
                                                     pad_head_dim,
                                                     padded_head_dim,
                                                     panel_bwd_reference,
                                                     split_weights)
from tgt_torch.ops.kernels.triplet_dense import (KV_ORDER, PAIR_ORDER, Q_ORDER,
                                                 dropout_mask, from_head_major,
                                                 to_head_major,
                                                 triplet_dense_bwd,
                                                 triplet_dense_bwd_reference)

from test_torch_port_dropout import assert_scaled_close, seeds_for
from test_torch_port_triplet import GEOMETRIES, core_inputs, pallas_core
from test_torch_port_triplet_bwd import cotangent, jax_grads

torch.set_num_threads(1)

NAMES = ("dq", "dk", "dv", "dbias", "dgate")
# bf16 against bf16: both sides round their outputs to bf16 (2^-8 of the
# value) and round ds to bf16 from f32 values whose last bits differ with
# the order of the sums, so one side's rounding may land one bf16 step from
# the other's; 2^-6 of max|ref| holds a few such steps per output. The
# card's kernel checks hold 1e-2 of max|ref| in bf16.
BF16_TOL = 2.0 ** -6
# the same plain formulas in f32 on two layouts: summation order only
F32_TOL = 1e-5


def _bf(x):
    return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


class TestPlainDenseBackwardBf16:
    @pytest.mark.parametrize("gated", [True, False])
    @pytest.mark.parametrize("geom", GEOMETRIES, ids=["N16H8", "N24H16"])
    def test_matches_pallas_vjp_in_bf16(self, geom, gated):
        q, k, v, bias, gate = core_inputs(*geom, seed=60)
        gate = gate if gated else None
        dva = cotangent(q, 61)
        bf = [None if x is None else np.asarray(_bf(x).float()) for x in
              (q, k, v, bias, gate, dva)]
        want = jax_grads(
            lambda *a: pallas_core(*a),
            *(None if x is None else jnp.asarray(x, jnp.bfloat16)
              for x in bf[:5]), jnp.asarray(bf[5], jnp.bfloat16))
        got = triplet_dense_bwd(*(None if x is None else _bf(x)
                                  for x in bf[:5]), _bf(bf[5]))
        for name, g, w in zip(NAMES, got, want):
            if w is None:
                assert g is None, name
                continue
            assert g.dtype == torch.bfloat16, name
            assert_scaled_close(g.float().numpy(),
                                np.asarray(w, np.float32), BF16_TOL, name)

    def test_rounds_ds_and_a_before_the_products(self):
        """The bf16 plain backward equals the f32 formulas with ds and a
        rounded to bf16 before dQ, dK and dV, bit for bit."""
        q, k, v, bias, gate = (_bf(x) for x in core_inputs(1, 8, 32, 4,
                                                           seed=62))
        dva = _bf(cotangent(q, 63))
        got = triplet_dense_bwd_reference(q, k, v, bias, gate, dva)
        ref32 = triplet_dense_bwd_reference(
            *(x.float() for x in (q, k, v, bias, gate, dva)))
        for name, g, r in zip(NAMES, got, ref32):
            # the rounding moves dq, dk, dv by about a bf16 step of ds
            assert_scaled_close(g.float().numpy(), r.numpy(), BF16_TOL, name)
        pn = torch.softmax(torch.einsum("bijdh,bjkdh->bjhik", q.float(),
                                        k.float())
                           + bias.float().permute(0, 3, 1, 2)[:, None], -1)
        g_ = torch.sigmoid(gate.float().permute(0, 3, 1, 2))[:, None]
        a = (pn * g_).to(torch.bfloat16).float()
        dv = torch.einsum("bjhik,bjidh->bjkdh", a, dva.float())
        torch.testing.assert_close(got[2], dv.to(torch.bfloat16), rtol=0,
                                   atol=0)


def dense_inputs(b, n, w, h, seed, transposed):
    q, k, v, bias, gate = (torch.from_numpy(x) for x in core_inputs(
        b, n, w, h, seed=seed))
    if transposed:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    return q, k, v, bias, gate


class TestRelayout:
    @pytest.mark.parametrize("transposed", [False, True])
    def test_round_trip_is_the_identity(self, transposed):
        q, k, v, _, _ = dense_inputs(2, 6, 12, 3, 64, transposed)
        for x, order in ((q, Q_ORDER), (k, KV_ORDER), (v, KV_ORDER)):
            t = to_head_major(x, order, 16)
            assert t.is_contiguous() and t.shape[-1] == 16
            assert not t[..., 4:].any()              # d = 4 padded with zeros
            back = from_head_major(t, order, 4)
            assert back.is_contiguous()
            torch.testing.assert_close(back, x, rtol=0, atol=0)

    def test_head_major_axes(self):
        q, k, _, bias, _ = dense_inputs(2, 5, 8, 2, 65, True)
        qt, kt = to_head_major(q, Q_ORDER, 4), to_head_major(k, KV_ORDER, 4)
        # q[b, i, j, :, h] is row i of panel (b, h, j); k[b, j, k, :, h] row k
        torch.testing.assert_close(qt[1, 0, 3, 2], q[1, 2, 3, :, 0])
        torch.testing.assert_close(kt[0, 1, 4, 1], k[0, 4, 1, :, 1])
        torch.testing.assert_close(bias.permute(*PAIR_ORDER)[1, 1, 2, 3],
                                   bias[1, 2, 3, 1])

    def test_pad_head_dim(self):
        x = torch.randn(2, 3, 5)
        assert pad_head_dim(x, 5) is x or pad_head_dim(x, 5).equal(x)
        p = pad_head_dim(x, 16)
        assert p.shape == (2, 3, 16) and p[..., :5].equal(x)
        assert not p[..., 5:].any()
        assert [padded_head_dim(d) for d in (1, 2, 4, 8, 16, 32)] == [
            16, 16, 16, 16, 16, 32]


def dense_through_panels(q, k, v, bias, gate, dva, seed=None, rate=0.0):
    """``triplet_dense_bwd_reference``'s outputs by the body's plain version
    on head-major copies, the keep mask in the head-major frame."""
    b, n, _, d, h = q.shape
    dp = padded_head_dim(d)
    keep = None
    if rate > 0.0:
        keep = dropout_mask(seed, n, h, rate).permute(0, 2, 1, 3, 4)
    out = panel_bwd_reference(
        to_head_major(q, Q_ORDER, dp), to_head_major(k, KV_ORDER, dp),
        to_head_major(v, KV_ORDER, dp), bias.permute(*PAIR_ORDER),
        None if gate is None else gate.permute(*PAIR_ORDER),
        to_head_major(dva, KV_ORDER, dp), 1.0, keep)
    pair_back = (0, 2, 3, 1)
    return (from_head_major(out[0], Q_ORDER, d),
            from_head_major(out[1], KV_ORDER, d),
            from_head_major(out[2], KV_ORDER, d),
            out[3].permute(*pair_back),
            None if out[4] is None else out[4].permute(*pair_back))


class TestPanelReference:
    @pytest.mark.parametrize("rate", [0.0, 0.3])
    @pytest.mark.parametrize("transposed", [False, True])
    @pytest.mark.parametrize("gated", [True, False])
    def test_dense_through_head_major(self, gated, transposed, rate):
        q, k, v, bias, gate = dense_inputs(2, 10, 24, 3, 66, transposed)
        gate = gate if gated else None
        dva = torch.from_numpy(cotangent(q.numpy(), 67))
        seed = torch.from_numpy(seeds_for(2, 68)) if rate else None
        want = triplet_dense_bwd_reference(q, k, v, bias, gate, dva, seed,
                                           rate)
        got = dense_through_panels(q, k, v, bias, gate, dva, seed, rate)
        for name, g, w in zip(NAMES, got, want):
            if w is None:
                assert g is None, name
                continue
            assert_scaled_close(g.numpy(), w.numpy(), F32_TOL, name)

    def test_dropout_mask_in_the_head_major_frame(self):
        """The body hashes (j n + i)(n H) + k H + h at panel (b, h, j), row
        i, key k: dropout_mask's (b, j, h, i, k) entries, moved."""
        from tgt_torch.ops.kernels.triplet_dense import hash_keep
        seed = torch.from_numpy(seeds_for(2, 69))
        n, h = 7, 3
        hm = dropout_mask(seed, n, h, 0.3).permute(0, 2, 1, 3, 4)
        b, hh, j, i, k = 1, 2, 5, 3, 6
        lin = torch.tensor((j * n + i) * (n * h) + k * h + hh)
        assert hm[b, hh, j, i, k] == hash_keep(lin, seed[b, 0], 0.3)

    @pytest.mark.parametrize("gated", [True, False])
    def test_legacy_in_f32(self, gated):
        rs = np.random.RandomState(70)
        b, h, n, d = 2, 4, 9, 8
        q, k, v, do = (torch.from_numpy(rs.randn(b, h, n, n, d).astype(
            np.float32)) for _ in range(4))
        bias = torch.from_numpy(rs.randn(b, h, n, n).astype(np.float32))
        gate = (torch.from_numpy(rs.randn(b, h, n, n).astype(np.float32))
                if gated else torch.full_like(bias, UNGATED_GATE))
        want = triplet_core_bwd_reference(q, k, v, bias, gate, do, d ** -0.5)
        got = panel_bwd_reference(q, k, v, bias, gate, do, d ** -0.5)
        for name, g, w in zip(NAMES, got, want):
            assert_scaled_close(g.numpy(), w.numpy(), F32_TOL, name)

    def test_legacy_split_weights_match_the_f32_weights_in_bf16(self):
        """The legacy instantiation feeds dv the weights p g as a bf16 high
        and low part, where tgt_tpu (and the legacy plain version) keep
        them in f32 (``triplet_attention.py:81-83``). hi + lo holds p g to
        about 2^-16 of its value, so in bf16 every output of the body's
        plain version lies within one bf16 step (2^-8) of max|ref| of
        ``triplet_core_bwd_reference``'s: both round the same f32 sums,
        whose last bits differ with the order of the sums."""
        rs = np.random.RandomState(71)
        b, h, n, d = 2, 4, 24, 16
        q, k, v, do = (torch.from_numpy(rs.randn(b, h, n, n, d).astype(
            np.float32)).to(torch.bfloat16) for _ in range(4))
        bias, gate = (torch.from_numpy(rs.randn(b, h, n, n).astype(
            np.float32)).to(torch.bfloat16) for _ in range(2))
        want = triplet_core_bwd_reference(q, k, v, bias, gate, do, 0.25)
        got = panel_bwd_reference(q, k, v, bias, gate, do, 0.25,
                                  split_dv=True)
        for name, g, w in zip(NAMES, got, want):
            assert_scaled_close(g.float().numpy(), w.float().numpy(),
                                2.0 ** -8, name)
        a = torch.rand(4096) * torch.rand(4096) + 1e-6
        err = (split_weights(a, torch.bfloat16) - a).abs() / a
        assert float(err.max()) <= 2.0 ** -16


class TestChunks:
    @pytest.mark.parametrize("pairs,nj", [(256, 48), (512, 48), (1024, 48),
                                          (16, 48), (2, 7), (1, 128)])
    def test_every_row_once_and_one_wave(self, pairs, nj):
        sms = 132
        jc, chunks = j_chunks(pairs, nj, sms)
        assert (chunks - 1) * jc < nj <= chunks * jc
        assert chunks == 1 or pairs * chunks <= BLOCKS_PER_SM * sms
