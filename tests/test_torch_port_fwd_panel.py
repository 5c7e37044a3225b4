"""The bf16 forward body shared by the dense and the legacy triplet core
(``tgt_torch/csrc/triplet_fwd_mma.cuh``) and what surrounds it, on the CPU.

1. The plain dense forward in bf16 against tgt_tpu's ``_dense_core`` in
   interpret mode, in bf16, on the same numpy inputs: the plain version
   rounds the unnormalised gated weights to bf16 before the product with V
   and multiplies by the reciprocal of the denominator afterwards, as
   ``_fwd_kernel`` does through ``_dot`` (``triplet_dense.py:243-252``).
2. The body's plain version ``panel_fwd_reference`` on relayouted dense
   inputs gives ``triplet_dense_fwd_reference``'s output, at rate 0 and at
   rate 0.3 with ``dropout_mask`` taken in the head-major frame, on the
   pair-transposed K/V views too; on the legacy inputs it gives
   ``triplet_core_fwd_reference``'s, in f32 the same formulas and in bf16
   within one bf16 step.
3. A fully masked sample stays finite, and zero when gated; the chunks of
   j the wrappers launch cover every row once.
4. The in-place loader's index maps (``inplace_fwd_kernel``), mirrored
   here: the 16-byte pieces it reads from the (b, i|j, j|k, d, h) layouts,
   the out direction's pair-transposed views included, are the head-major
   panels' rows; its shared-memory transposes (``ldmatrix.trans`` of 8 x 8
   blocks) put every element in its head's panel and every output element
   back at its (i, d, h) place; ``reads_in_place`` takes the shapes and
   alignments the kernel takes.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tgt_torch.ops.kernels.triplet_attention import (
    UNGATED_GATE, triplet_core_fwd_reference)
from tgt_torch.ops.kernels.triplet_bwd_panel import j_chunks, padded_head_dim
from tgt_torch.ops.kernels.triplet_dense import (INPLACE_GROUP, KV_ORDER,
                                                 PAIR_ORDER, Q_ORDER,
                                                 dropout_mask, from_head_major,
                                                 reads_in_place, to_head_major,
                                                 triplet_dense_fwd,
                                                 triplet_dense_fwd_reference)
from tgt_torch.ops.kernels.triplet_fwd_panel import (FWD_BLOCKS_PER_SM,
                                                     panel_fwd_reference)

from test_torch_port_bwd_panel import dense_inputs
from test_torch_port_dropout import assert_scaled_close, seeds_for
from test_torch_port_triplet import GEOMETRIES, core_inputs, pallas_core

torch.set_num_threads(1)

# bf16 against bf16. Both sides round the unnormalised weights to bf16
# (2^-9 of each weight) and the output to bf16 (2^-8 of the value), but
# from other f32 values: the port takes the softmax max per (i, h), the TPU
# kernel the max over the whole row of every head (triplet_dense.py:207-212),
# which scales a head's weights by exp(its max - the row max) before they
# are rounded, and its denominator sums the bf16-rounded numerators
# (_attn_tile, :216). So the two cannot agree bit for bit; a weight or an
# output may land a bf16 step from the other side's, and 2^-6 of max|ref|
# holds a few such steps, as the backward's test holds them.
BF16_TOL = 2.0 ** -6
# one bf16 step of the largest output: the same formulas on two layouts,
# whose f32 sums differ in their last bits before the rounding
STEP = 2.0 ** -8
# the same plain formulas in f32 on two layouts: summation order only
F32_TOL = 1e-5


def _bf(x):
    return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


class TestPlainDenseForwardBf16:
    @pytest.mark.parametrize("gated", [True, False])
    @pytest.mark.parametrize("geom", GEOMETRIES, ids=["N16H8", "N24H16"])
    def test_matches_pallas_forward_in_bf16(self, geom, gated):
        q, k, v, bias, gate = core_inputs(*geom, seed=80)
        gate = gate if gated else None
        bf = [None if x is None else np.asarray(_bf(x).float())
              for x in (q, k, v, bias, gate)]
        want = pallas_core(*(None if x is None else jnp.asarray(x, jnp.bfloat16)
                             for x in bf))
        got = triplet_dense_fwd(*(None if x is None else _bf(x) for x in bf))
        assert got.dtype == torch.bfloat16
        assert_scaled_close(got.float().numpy(), np.asarray(want, np.float32),
                            BF16_TOL, "va")

    @pytest.mark.parametrize("rate", [0.0, 0.3])
    def test_rounds_the_unnormalised_weights_before_the_product(self, rate):
        """The bf16 plain forward equals the f32 formulas with the
        unnormalised gated weights (times the keep mask) rounded to bf16
        before the product and the reciprocal of the clamped denominator
        applied after it, bit for bit."""
        q, k, v, bias, gate = (_bf(x) for x in core_inputs(2, 8, 32, 4,
                                                           seed=81))
        seed = torch.from_numpy(seeds_for(2, 82))
        got = triplet_dense_fwd_reference(q, k, v, bias, gate, seed, rate)
        s = (torch.einsum("bijdh,bjkdh->bjhik", q.float(), k.float())
             + bias.float().permute(0, 3, 1, 2)[:, None])
        e = torch.exp(s - s.amax(-1, keepdim=True))
        a = e * torch.sigmoid(gate.float().permute(0, 3, 1, 2))[:, None]
        if rate:
            a = a * dropout_mask(seed, 8, 4, rate)
        va = torch.einsum("bjhik,bjkdh->bjidh", a.to(torch.bfloat16).float(),
                          v.float())
        recip = 1.0 / e.sum(-1).clamp_min(1e-30)
        want = (va * recip.permute(0, 1, 3, 2)[:, :, :, None]).to(
            torch.bfloat16)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        # rounding the normalised weights instead moves the output
        norm = torch.einsum("bjhik,bjkdh->bjidh",
                            (a * recip[..., None]).to(torch.bfloat16).float(),
                            v.float()).to(torch.bfloat16)
        assert not torch.equal(got, norm)


def dense_through_panels(q, k, v, bias, gate, seed=None, rate=0.0):
    """``triplet_dense_fwd_reference``'s output by the body's plain version
    on head-major copies, the keep mask in the head-major frame."""
    b, n, _, d, h = q.shape
    dp = padded_head_dim(d)
    keep = None
    if rate > 0.0:
        keep = dropout_mask(seed, n, h, rate).permute(0, 2, 1, 3, 4)
    out = panel_fwd_reference(
        to_head_major(q, Q_ORDER, dp), to_head_major(k, KV_ORDER, dp),
        to_head_major(v, KV_ORDER, dp), bias.permute(*PAIR_ORDER),
        None if gate is None else gate.permute(*PAIR_ORDER), 1.0, keep)
    return from_head_major(out, KV_ORDER, d)


def legacy_inputs(b, h, n, d, gated, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.randn(b, h, n, n, d).astype(np.float32))
               for _ in range(3))
    bias = torch.from_numpy(rs.randn(b, h, n, n).astype(np.float32))
    gate = (torch.from_numpy(rs.randn(b, h, n, n).astype(np.float32))
            if gated else torch.full_like(bias, UNGATED_GATE))
    return q, k, v, bias, gate


class TestPanelForwardReference:
    @pytest.mark.parametrize("rate", [0.0, 0.3])
    @pytest.mark.parametrize("transposed", [False, True])
    @pytest.mark.parametrize("gated", [True, False])
    def test_dense_through_head_major(self, gated, transposed, rate):
        q, k, v, bias, gate = dense_inputs(2, 10, 24, 3, 83, transposed)
        gate = gate if gated else None
        seed = torch.from_numpy(seeds_for(2, 84)) if rate else None
        want = triplet_dense_fwd_reference(q, k, v, bias, gate, seed, rate)
        got = dense_through_panels(q, k, v, bias, gate, seed, rate)
        assert_scaled_close(got.numpy(), want.numpy(), F32_TOL, "va")

    @pytest.mark.parametrize("rate", [0.0, 0.3])
    def test_dense_through_head_major_in_bf16(self, rate):
        q, k, v, bias, gate = (x.to(torch.bfloat16) for x in dense_inputs(
            2, 12, 64, 4, 85, True))
        seed = torch.from_numpy(seeds_for(2, 86)) if rate else None
        want = triplet_dense_fwd_reference(q, k, v, bias, gate, seed, rate)
        got = dense_through_panels(q, k, v, bias, gate, seed, rate)
        assert got.dtype == torch.bfloat16
        assert_scaled_close(got.float().numpy(), want.float().numpy(), STEP,
                            "va")

    @pytest.mark.parametrize("gated", [True, False])
    def test_legacy_in_f32(self, gated):
        q, k, v, bias, gate = legacy_inputs(2, 4, 9, 8, gated, seed=87)
        want = triplet_core_fwd_reference(q, k, v, bias, gate, 8 ** -0.5)
        got = panel_fwd_reference(q, k, v, bias, gate, 8 ** -0.5, dense=False)
        assert_scaled_close(got.numpy(), want.numpy(), F32_TOL, "out")

    def test_legacy_in_bf16(self):
        """Both round the normalised weights times the gate to bf16 before
        the product (``triplet_attention.py:50``): within one bf16 step."""
        q, k, v, bias, gate = (x.to(torch.bfloat16) for x in legacy_inputs(
            2, 4, 24, 16, True, seed=88))
        want = triplet_core_fwd_reference(q, k, v, bias, gate, 0.25)
        got = panel_fwd_reference(q, k, v, bias, gate, 0.25, dense=False)
        assert got.dtype == torch.bfloat16
        assert_scaled_close(got.float().numpy(), want.float().numpy(), STEP,
                            "out")

    @pytest.mark.parametrize("dense", [True, False])
    def test_fully_masked_sample_is_finite_and_zero_when_gated(self, dense):
        q, k, v, bias, gate = legacy_inputs(2, 3, 8, 16, True, seed=89)
        bias[0] = -1e9
        gate[0] = -1e9
        out = panel_fwd_reference(*(x.to(torch.bfloat16) for x in (
            q, k, v, bias, gate)), 0.25, dense=dense)
        assert torch.isfinite(out.float()).all()
        assert not out[0].any() and out[1].any()


class TestForwardChunks:
    @pytest.mark.parametrize("pairs,nj", [(256, 48), (512, 48), (1024, 48),
                                          (64, 128), (2, 7), (1, 128)])
    def test_every_row_once_and_about_one_wave(self, pairs, nj):
        sms = 132
        jc, chunks = j_chunks(pairs, nj, sms, FWD_BLOCKS_PER_SM)
        assert (chunks - 1) * jc < nj <= chunks * jc
        assert chunks == 1 or pairs * chunks <= FWD_BLOCKS_PER_SM * sms


def loader_pieces(x, b, j, g, is_q):
    """The pieces ``fetch`` of ``inplace_fwd_kernel`` copies for one tensor
    at (b, j) and head group g, read where it reads them: piece (r, c) at
    ``src + r * rs + c * H + g * 8`` (``triplet_fwd_mma.cuh``), with src
    at (b, 0, j) for q (rows i of column j, ``rs`` its i stride) and at
    (b, j, 0) for k and v (rows k of row j). Returns (n, d, 8)."""
    n, h = x.shape[1], x.shape[4]
    st = x.stride()
    src = b * st[0] + j * (st[2] if is_q else st[1])
    rs = st[1] if is_q else st[2]
    return torch.as_strided(x, (n, x.shape[3], INPLACE_GROUP), (rs, h, 1),
                            x.storage_offset() + src + g * INPLACE_GROUP)


def ldsm_trans(tile, rows):
    """ldmatrix.x4.trans: ``rows[m][r]`` is the element offset of row r of
    8 x 8 block m in ``tile``; thread t (gid t / 4, tig t % 4) gets, per
    block, the pair (M[2 tig][gid], M[2 tig + 1][gid])."""
    out = np.zeros((32, 4, 2), tile.dtype)
    for m in range(4):
        blk = np.stack([tile[o:o + 8] for o in rows[m]])
        for t in range(32):
            out[t, m] = blk[2 * (t & 3), t >> 2], blk[2 * (t & 3) + 1, t >> 2]
    return out


class TestInPlaceLoader:
    @pytest.mark.parametrize("transposed", [False, True])
    def test_pieces_are_the_head_major_rows(self, transposed):
        q, k, v, _, _ = dense_inputs(2, 6, 256, 16, 90, transposed)
        for b, j, g in ((0, 0, 0), (1, 5, 1), (1, 2, 0)):
            for x, order, is_q in ((q, Q_ORDER, True), (k, KV_ORDER, False),
                                   (v, KV_ORDER, False)):
                want = to_head_major(x, order, 16)[b, 8 * g:8 * g + 8, j]
                got = loader_pieces(x, b, j, g, is_q)
                torch.testing.assert_close(got.permute(2, 0, 1), want,
                                           rtol=0, atol=0)

    @pytest.mark.parametrize("n,d", [(48, 16), (45, 16), (24, 8), (33, 8),
                                     (1, 16)])
    def test_shared_memory_transposes(self, n, d):
        """The kernel's block loops, index for index: raw [3][n][d][8] ->
        per-head panels [3][8][HS] (row stride PS = 24), then each head's
        Q panel -> out[i, d, 8 g + h] of a row of H = 16 heads."""
        kt = 2 if n <= 32 else 3
        ps, np_ = 24, 16 * kt
        hs = (np_ * ps + 63) // 64 * 64 + 8          # head_stride
        ld = 4 if d == 16 else 3
        lcb, warps = ld - 3, 4 * kt
        mask, per, blocks = (1 << lcb) - 1, n << ld, n << lcb
        src = np.random.RandomState(n).randn(3, n, d, 8).astype(np.float32)
        raw, panels = src.reshape(-1), np.zeros(3 * 8 * hs, np.float32)
        for p in range(3):
            for w in range(warps):
                for q0 in range(w * 4, blocks, warps * 4):
                    rows = [[p * per * 8 + ((((min(q0 + m, blocks - 1) >> lcb)
                                               << ld) + ((min(q0 + m, blocks - 1)
                                                          & mask) << 3) + r) << 3)
                             for r in range(8)] for m in range(4)]
                    t4 = ldsm_trans(raw, rows)
                    for t in range(32):
                        for m in range(4):
                            blk = q0 + m
                            if blk < blocks:
                                o = ((p * 8 + (t >> 2)) * hs + 2 * (t & 3)
                                     + (blk >> lcb) * ps + ((blk & mask) << 3))
                                panels[o:o + 2] = t4[t, m]
        for p in range(3):
            for hh in range(8):
                pan = panels[(p * 8 + hh) * hs:][:np_ * ps].reshape(np_, ps)
                np.testing.assert_array_equal(pan[:n, :d], src[p, :, :, hh])
                assert not pan[n:].any() and not pan[:, d:].any()
        out, h, hg = np.full(n * d * 16, np.nan, np.float32), 16, 8
        for w in range(warps):
            for q0 in range(w * 4, blocks, warps * 4):
                rows = [[r * hs + (min(q0 + m, blocks - 1) >> lcb) * ps
                         + ((min(q0 + m, blocks - 1) & mask) << 3)
                         for r in range(8)] for m in range(4)]
                t4 = ldsm_trans(panels, rows)
                for t in range(32):
                    for m in range(4):
                        blk = q0 + m
                        if blk < blocks:
                            o = hg + 2 * (t & 3) + (((blk >> lcb) << ld)
                                                    + ((blk & mask) << 3)
                                                    + (t >> 2)) * h
                            out[o:o + 2] = t4[t, m]
        out = out.reshape(n, d, h)
        np.testing.assert_array_equal(out[:, :, hg:], src[0])
        assert np.isnan(out[:, :, :hg]).all()

    def test_reads_in_place_takes_what_the_kernel_takes(self):
        q, k, v, bias, gate = dense_inputs(2, 6, 256, 16, 91, True)
        assert reads_in_place(q, k, v, bias, gate)
        assert reads_in_place(q, k, v, bias, None)
        assert not reads_in_place(*dense_inputs(1, 49, 256, 16, 92, False))
        assert not reads_in_place(*dense_inputs(2, 6, 512, 16, 93, False))
        assert not reads_in_place(*dense_inputs(2, 6, 48, 12, 94, False))
        off = torch.zeros(q.numel() + 1)[1:].view(q.shape)   # 4-byte aligned
        assert not reads_in_place(off, k, v, bias, gate)
