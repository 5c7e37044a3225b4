"""The one-pass residual junction's plain version and its route
(``tgt_torch/ops/kernels/residual.py``, ``ops/common.residual``) on the
CPU: the plain version against today's composite ``x + drop_path(y)`` in
bf16, fp16 and f32, at rate 0, above 0 and deterministic; the route's
predicate and what ``residual`` observes for it; the kernel route's draws,
which must be the composite's; every junction of ``TGTLayer`` through
``ops/common.residual``; and a seeded stochastic draw-stacked TGT-Agx2
forward, equal bit for bit to the forward that adds ``x + drop_path(y)``
as the encoder did before the junction had a route. The kernel itself
runs only on the card (``python3 chip_smoke.py --phases 2j,5j``).

On the CPU the plain version (a multiply by the reciprocal of the keep
probability taken in double and rounded to f32, as PyTorch's CUDA
``tensor / scalar`` computes it) and the composite (the CPU's ``tensor /
scalar`` divides) differ: in bf16 and fp16 they are bitwise equal at the
rates 0.1 / 11, 0.1 and 0.3 (and the junction's CPU route is the composite
itself), and one step of the output type apart on about 1% of the
elements at 0.4, where the f32 quotient and product straddle a rounding
boundary (the scaled update one step apart, the sum at most two); in f32
they differ by at most one ulp of the scaled update. On the card the kernel
equals the composite bit for bit at every rate of the published ramps
(``chip_smoke.py`` phase 2j).
"""
import numpy as np
import pytest
import torch

from tgt_torch.core.graph import Graph
from tgt_torch.data.synthetic import make_molecule
from tgt_torch.models import encoder
from tgt_torch.models.heads import make_model
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops import common
from tgt_torch.ops.kernels import residual as rk
from tgt_torch.serving import DistancePredictor

torch.set_num_threads(1)

RATES = [0.0, 0.1 / 11, 0.1, 0.4]
DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _pair(seed, shape, dtype):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3
    y = torch.randn(shape, generator=g) * 2
    x.view(-1)[:4] = torch.tensor([0.0, -0.0, -0.0, 0.0])   # signed zeros
    y.view(-1)[:4] = torch.tensor([0.0, 0.0, -0.0, -1.0])
    return x.to(dtype), y.to(dtype)


def _steps(got, want, scaled):
    """|got - want| in steps of their dtype at the larger magnitude of the
    two and of the scaled update (a step of the update carries into the
    sum), the largest over the elements."""
    mantissa = {torch.bfloat16: 8, torch.float16: 11}[got.dtype]
    got, want = got.float(), want.float()
    big = torch.maximum(torch.maximum(got.abs(), want.abs()),
                        scaled.float().abs())
    _, exp = torch.frexp(big)
    step = torch.ldexp(torch.ones_like(got), exp - mantissa)
    return ((got - want).abs() / step).max().item()


def _composite(x, y, rate, deterministic, generator):
    """The junction as the encoder added it before it had a route."""
    return x + common.drop_path(y, rate, deterministic, generator)


def _gens(seed, draws=None):
    if draws is None:
        return torch.Generator().manual_seed(seed)
    return tuple(torch.Generator().manual_seed(seed + s)
                 for s in range(draws))


@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["stochastic", "deterministic"])
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_version_against_the_composite(dtype, rate, deterministic):
    x, y = _pair(3, (40, 3, 3, 64), dtype)
    want = _composite(x, y, rate, deterministic, _gens(7))
    u = None
    if not (deterministic or rate == 0.0):
        u = common.rand((40, 1, 1, 1), _gens(7), "cpu")
    got = rk.residual_fwd(x, y, u, 1.0 - rate)         # the CPU's plain
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        scale = max(x.abs().max().item(), 2 * y.abs().max().item() / (1 - rate))
        assert (got - want).abs().max().item() <= 2 ** -23 * 2 * scale
    elif rate == 0.4 and not deterministic:   # the CPU's division
        # one step of the scaled update, carried through the sum's rounding
        assert _steps(got, want, y / (1.0 - rate)) <= 2.0
        assert 0 < (got != want).float().mean().item() < 0.03
    else:
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))
    if u is not None:
        keep = (u.view(-1) < 1.0 - rate)
        assert not keep.all() or rate < 0.1        # some samples drop
        assert torch.equal(got[~keep], x[~keep] + 0 * y[~keep])


@pytest.mark.parametrize("dtype,shape,taken", [
    (torch.bfloat16, (160, 56, 56, 256), True),
    (torch.bfloat16, (160, 56, 768), True),
    (torch.float16, (2, 8), True),
    (torch.bfloat16, (160, 56, 12), False),             # rows not 16 bytes
    (torch.bfloat16, (256,), False),                    # no sample axis
    (torch.float32, (160, 56, 768), False)], ids=str)
def test_shapes_and_dtypes_the_kernel_takes(dtype, shape, taken):
    assert rk.takes(dtype, shape) is taken


@pytest.mark.parametrize("device,dtype,shape,matched,grad,route", [
    ("cuda", torch.bfloat16, (160, 24, 24, 256), True, False, "kernel"),
    ("cuda", torch.bfloat16, (160, 24, 768), True, False, "kernel"),
    ("cuda", torch.float16, (160, 24, 24, 256), True, False, "kernel"),
    ("cuda", torch.bfloat16, (160, 24, 24, 256), True, True, "composite"),
    ("cuda", torch.float32, (160, 24, 24, 256), True, False, "composite"),
    ("cuda", torch.bfloat16, (160, 24, 24, 256), False, False, "composite"),
    ("cuda", torch.bfloat16, (160, 24, 24, 4), True, False, "composite"),
    ("cpu", torch.bfloat16, (160, 24, 24, 256), True, False, "composite")],
    ids=["edge", "node", "fp16", "grad", "f32", "unmatched", "narrow", "cpu"])
def test_route(device, dtype, shape, matched, grad, route):
    assert common.residual_route(device, dtype, shape, matched, grad) == route


@pytest.fixture
def routes(monkeypatch):
    """Record the arguments of every route decision, and decide
    ``routes.decide`` (None: the real route)."""
    class Routes:
        decide = None
        calls = []

    saved = common.residual_route

    def route(*args):
        Routes.calls.append(args)
        return Routes.decide or saved(*args)

    monkeypatch.setattr(common, "residual_route", route)
    return Routes


def test_residual_observes_layout_and_autograd(routes):
    x, y = _pair(1, (4, 3, 16), torch.bfloat16)
    common.residual(x, y, 0.1, True, None)
    common.residual(x, y.transpose(1, 2).contiguous().transpose(1, 2),
                    0.1, True, None)                     # strided update
    common.residual(x, y[:, :1], 0.1, True, None)       # broadcast update
    common.residual(x, y.float(), 0.1, True, None)      # another dtype
    flat = torch.empty(x.numel() + 4, dtype=x.dtype)
    off = flat[4:].view(x.shape)                         # 8-byte offset
    off.copy_(y)
    common.residual(x, off, 0.1, True, None)
    xg = x.float().requires_grad_()
    common.residual(xg, y.float(), 0.1, True, None)
    with torch.no_grad():
        common.residual(xg, y.float(), 0.1, True, None)
    assert [(c[0], c[1], tuple(c[2]), c[3], c[4]) for c in routes.calls] == [
        ("cpu", torch.bfloat16, (4, 3, 16), True, False),
        ("cpu", torch.bfloat16, (4, 3, 16), False, False),
        ("cpu", torch.bfloat16, (4, 3, 16), False, False),
        ("cpu", torch.bfloat16, (4, 3, 16), False, False),
        ("cpu", torch.bfloat16, (4, 3, 16), False, False),
        ("cpu", torch.float32, (4, 3, 16), True, True),
        ("cpu", torch.float32, (4, 3, 16), True, False)]


@pytest.mark.parametrize("draws", [None, 3], ids=["one", "stacked"])
@pytest.mark.parametrize("rate,deterministic", [
    (0.0, False), (0.1, False), (0.3, False), (0.1, True)])
def test_kernel_route_draws_the_composite_mask(routes, rate, deterministic,
                                               draws):
    """Forced to the kernel route, ``residual`` on the CPU runs the plain
    version on the u it draws: equal to the composite bit for bit, and each
    generator left in the composite's state."""
    rows = 6 if draws is None else 6 * draws
    x, y = _pair(5, (rows, 4, 4, 32), torch.bfloat16)
    want_gens, got_gens = _gens(11, draws), _gens(11, draws)
    want = _composite(x, y, rate, deterministic, want_gens)
    routes.decide = "kernel"
    before = rk.residual_fwd.launches
    got = common.residual(x, y, rate, deterministic, got_gens)
    assert rk.residual_fwd.launches == before          # no card, no launch
    assert torch.equal(got, want)
    for a, b in zip(*(g if isinstance(g, tuple) else (g,)
                      for g in (want_gens, got_gens))):
        assert torch.equal(a.get_state(), b.get_state())


def test_wrapper_refuses_what_it_cannot_take():
    x, y = _pair(2, (4, 3, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="agree in shape"):
        rk.residual_fwd(x, y[:, :2])
    with pytest.raises(ValueError, match="one draw per sample"):
        rk.residual_fwd(x, y, torch.rand(3), 0.9)


def test_composite_keeps_its_gradient_on_cpu():
    x, y = _pair(4, (4, 3, 16), torch.float32)
    x.requires_grad_()
    y.requires_grad_()
    out = common.residual(x, y, 0.3, False, _gens(2))
    out.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    keep = (y.grad.flatten(1) != 0).any(1)
    assert torch.equal(y.grad[keep], torch.full_like(y[keep], 1 / 0.7))


# -- the encoder -----------------------------------------------------------------

SMALL = dict(node_width=16, edge_width=32, num_heads=4, model_height=2,
             triplet_heads=8, num_dist_bins=8, source_dropout=0.2,
             drop_path=0.3, node_act_dropout=0.1, edge_act_dropout=0.1,
             triplet_type="aggregate", use_pallas="dense",
             triplet_dropout=0.2, layer_multiplier=2)


def _graph(b, n, cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    mask = torch.zeros(b, n, n, 1)
    mask[0, :, -1] = -1e9
    return Graph(h=torch.randn(b, n, cfg.node_width, generator=g),
                 e=torch.randn(b, n, n, cfg.edge_width, generator=g),
                 mask=mask, node_mask=torch.ones(b, n))


@pytest.mark.parametrize("node_update,junctions", [(True, 5), (False, 3)],
                         ids=["node_and_edge", "edge_only"])
def test_every_junction_of_a_layer_goes_through_residual(
        monkeypatch, node_update, junctions):
    cfg = TGTConfig(**SMALL)
    layer = encoder.TGTLayer(cfg, node_update, True)
    common.init_module_(layer, torch.Generator().manual_seed(0))
    g = _graph(2, 5, cfg)
    calls = []

    def counted(x, update, rate, deterministic, generator):
        calls.append((tuple(x.shape), rate, deterministic))
        return common.residual(x, update, rate, deterministic, generator)

    monkeypatch.setattr(encoder, "residual", counted)
    out = layer(g, drop_path_rate=0.25, deterministic=False,
                generator=torch.Generator().manual_seed(3))
    node, edge = tuple(g.h.shape), tuple(g.e.shape)
    want = ([node, node] if node_update else []) + [edge, edge, edge]
    assert [c[0] for c in calls] == want and len(calls) == junctions
    assert all(c[1:] == (0.25, False) for c in calls)
    assert out.e.shape == g.e.shape


def _molecules(sizes=(5, 9, 3), seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for n in sizes:
        m = make_molecule(rs, int(n))
        m["coords"] = m.pop("rdkit_coords")
        for k in ("dft_coords", "target"):
            m.pop(k)
        out.append(m)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_draw_stacked_agx2_forward_unchanged(monkeypatch, routes, dtype):
    """A seeded stochastic TGT-Agx2 request under ``mc_mode`` vmap (3 draws
    stacked into one forward): through ``ops/common.residual`` (the
    composite on the CPU), through its kernel route (the plain version, in
    bf16 only, where it equals the composite), and through the encoder's
    former ``x + drop_path(y)``: the same probabilities bit for bit."""
    cfg = TGTConfig(**dict(SMALL, compute_dtype=dtype, node_ended=False,
                           edge_ended=True))
    model = make_model("distance", cfg, device="cpu", seed=0)
    pred = DistancePredictor(model, cfg, mc_samples=3, batch_size=4,
                             buckets=(16,), seed=4, device="cpu",
                             mc_mode="vmap")
    mols = _molecules()

    def request():
        pred._seeds.manual_seed(9)
        return pred.predict(mols)

    got = request()
    assert np.isfinite(got).all()
    unmatched = [c for c in routes.calls if not c[3]]
    # layer 0 twice with both updates, the edge-only last layer twice
    assert len(routes.calls) == 2 * 5 + 2 * 3 and not unmatched, unmatched
    if dtype == "bfloat16":
        routes.decide = "kernel"
        assert np.array_equal(request(), got)
        routes.decide = None
    monkeypatch.setattr(encoder, "residual", _composite)
    assert np.array_equal(request(), got)
