"""The rest of tgt_tpu's encoder in tgt_torch: the remat policies and
IndivConfig (CPU, float32, small shapes: node 16, edge 8, 4 heads, 2
triplet heads; the kernels' plain versions).

- every ``remat_policy`` gives the outputs and gradients of ``none``
  (bitwise) and tgt_tpu's under the same policy (1e-5 of max|ref|), on the
  dense attention path, the plain attention path and the dense aggregate
  path;
- what each policy saves, recorded as it is kept: the named values in a
  policy's cache (``proj``: the N^2 projections and no N^3 tensor;
  ``tri_va``: those and the dense kernel's output, after which the replay
  calls no forward kernel) and the products ``dots`` keeps;
- with dropout and drop path on, every policy's gradients equal those
  without remat, and fail to once a layer's generator is made outside the
  checkpointed function (the mutation);
- IndivConfig: a model whose layers mix the attention and aggregate
  variants, triplet heads 2 and 0, heads and activations, against
  tgt_tpu's unrolled path (logits and gradients, with and without remat);
  its ``indiv`` weight bridge both ways and through both packages'
  checkpoints; a yaml list reaching the encoder through the scheme.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.models.convert import convert_torch_state_dict
from tgt_tpu.models.heads import make_model as jax_make_model
from tgt_tpu.models.model_config import TGTConfig as JaxTGTConfig
from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.training import checkpoint as jckpt
from tgt_torch.models import encoder as encoder_module
from tgt_torch.models.convert import (jax_params_from_state_dict,
                                      state_dict_from_jax_params)
from tgt_torch.models.heads import make_model
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops import remat
from tgt_torch.ops.kernels import triplet_aggregate as ta
from tgt_torch.ops.kernels import triplet_dense as td
from tgt_torch.schemes import get_scheme
from tgt_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

B, N = 3, 10
COMMON = dict(node_width=16, edge_width=8, num_heads=4, triplet_heads=2,
              num_dist_bins=8)
DROPOUT = dict(source_dropout=0.3, drop_path=0.3, node_act_dropout=0.2,
               edge_act_dropout=0.2, triplet_dropout=0.2)
PATHS = {"attention-dense": dict(triplet_type="attention", use_pallas="dense"),
         "attention-plain": dict(triplet_type="attention", use_pallas=False),
         "aggregate-dense": dict(triplet_type="aggregate", use_pallas="dense")}
# per-layer configs: the attention and aggregate variants, a layer without
# a triplet sub-layer, two head counts and two activations
INDIV = dict(triplet_type=("attention", "aggregate", "aggregate"),
             triplet_heads=(2, 4, 0), num_heads=(4, 2, 4),
             activation=("gelu", "relu", "gelu"))


def feed(seed=2):
    """A feed with a padded sample and a sample of 3 atoms."""
    rs = np.random.RandomState(seed)
    nm = np.ones((B, N), np.float32)
    nm[1, N - 4:] = 0
    nm[2, 3:] = 0
    coords = rs.standard_normal((B, N, 3)).astype(np.float32) * 1.5
    return {
        "node_features": (rs.randint(0, 60, size=(B, N, 9))
                          * nm[..., None]).astype(np.int32),
        "distance_matrix": rs.randint(0, 34, size=(B, N, N)).astype(np.int32),
        "feature_matrix": rs.randint(0, 5, size=(B, N, N, 3)).astype(np.int32),
        "node_mask": nm,
        "edge_mask": nm[:, :, None] * nm[:, None, :],
        "dist_input": np.linalg.norm(coords[:, :, None] - coords[:, None],
                                     axis=-1).astype(np.float32),
    }


def torch_feed(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_outputs(cfg, batch, params=None, deterministic=True, seed=None):
    """Logits and every parameter's gradient of mean(logits^2) from the
    port's distance model (weights from ``params`` or from seed 1)."""
    model = make_model("distance", cfg, device="cpu", seed=1)
    if params is not None:
        model.load_state_dict(state_dict_from_jax_params(np_tree(params), cfg))
    out = model(torch_feed(batch), deterministic=deterministic, seed=seed)
    out.square().mean().backward()
    return out.detach(), {k: p.grad for k, p in model.named_parameters()}


def jax_outputs(jcfg, params, batch):
    _, apply = jax_make_model("distance")

    def loss(p):
        out = apply(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                    deterministic=True)
        return jnp.mean(out.astype(jnp.float32) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(out), grads


def assert_matches_jax(got, jgot, cfg, tol=1e-5):
    out, grads = got
    jout, jgrads = jgot
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=tol * np.abs(jout).max())
    ref = state_dict_from_jax_params(np_tree(jgrads), cfg)
    assert set(grads) == set(ref)
    for k, g in grads.items():
        r = ref[k].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=k)


def jax_init(jcfg, seed=0):
    init, _ = jax_make_model("distance")
    return init(jax.random.PRNGKey(seed), jcfg)


# -- the remat policies ---------------------------------------------------------

@pytest.mark.parametrize("policy", remat.REMAT_POLICIES)
def test_policy_matches_none_and_tgt_tpu(policy):
    """Per path: the policy's logits and gradients equal ``none``'s in every
    bit, and tgt_tpu's under the same policy to 1e-5 of max|ref| (tgt_tpu
    takes its jnp path at these widths, as in tests/test_models.py, for
    both attention paths of the port)."""
    batch = feed()
    refs = {}
    for path, kw in PATHS.items():
        base = dict(COMMON, model_height=2, **kw)
        jcfg = JaxTGTConfig(**base, remat=True, remat_policy=policy)
        if kw["triplet_type"] not in refs:
            params = jax_init(jcfg)
            refs[kw["triplet_type"]] = params, jax_outputs(jcfg, params, batch)
        params, ref = refs[kw["triplet_type"]]
        got = {}
        for p in ("none", policy):
            cfg = TGTConfig(**base, remat=True, remat_policy=p)
            got[p] = port_outputs(cfg, batch, params)
        assert_matches_jax(got[policy], ref, cfg)
        assert torch.equal(got[policy][0], got["none"][0]), path
        for k, g in got["none"][1].items():
            assert torch.equal(got[policy][1][k], g), (path, k)


def record_saved(monkeypatch):
    """(kind, name, shape) of every value a policy keeps: the values a
    named policy records in its cache, and the products ``dots`` keeps
    (their shapes from running them on the meta device)."""
    saved = []
    record, decide = remat.RematCache.record, remat._save

    def recorded(cache, name, value):
        saved.append(("named", name, tuple(value.shape)))
        record(cache, name, value)

    def meta(x):
        return x.to("meta") if isinstance(x, torch.Tensor) else x

    def decided(op, args):
        keep = decide(op, args)
        if keep:
            saved.append((op.name().split("::")[-1], None,
                          tuple(op(*map(meta, args)).shape)))
        return keep

    monkeypatch.setattr(remat.RematCache, "record", recorded)
    monkeypatch.setattr(remat, "_save", decided)
    return saved


def count_calls(monkeypatch, module, name):
    calls = [0]
    wrapped = getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("policy", remat.REMAT_POLICIES)
def test_policy_saves_what_tgt_tpu_names(monkeypatch, policy, path):
    """A 3-layer model, 2 checkpointed layers, 2 directions: what each
    policy keeps, and the forward-kernel calls of one training step (the
    plain versions stand for the kernels on the CPU)."""
    saved = record_saved(monkeypatch)
    dense_calls = count_calls(monkeypatch, td, "triplet_dense_fwd")
    agg_calls = count_calls(monkeypatch, ta, "triplet_aggregate_fwd")
    kw = PATHS[path]
    # 4 triplet heads: an N^3 tensor (b n^3 h) outgrows every N^2 one (the
    # QKV projection's b n^2 3w)
    cfg = TGTConfig(**dict(COMMON, triplet_heads=4), model_height=3,
                    remat=True, remat_policy=policy, **kw)
    port_outputs(cfg, feed())
    h, w = cfg.triplet_heads, cfg.edge_width

    def n3(shape):
        return int(np.prod(shape)) >= B * N ** 3 * h

    marks = sorted(name for kind, name, _ in saved
                   if kind == "named" and name != "tri_va")
    kernel = [shape for _, name, shape in saved if name == "tri_va"]
    products = [shape for kind, _, shape in saved
                if kind in ("mm", "addmm", "bmm")]
    attention = kw["triplet_type"] == "attention"
    dense = kw["use_pallas"] == "dense"
    # 2 checkpointed layers x 2 directions: q, k, v, bias and gate each
    want = {"tri_a": ["tri_a"] * 4 if not dense else [],
            "proj": ["tri_proj"] * 20 if attention else [],
            "tri_va": ["tri_proj"] * 20 if attention else []}
    assert marks == want.get(policy, [])
    # tri_va: the dense kernel's output (b, j, i, d, h) of each direction
    assert kernel == ([(B, N, N, w // h, h)] * 4
                      if policy == "tri_va" and attention and dense else [])
    if policy == "dots":
        assert products and len(products) == len(saved)
        # the plain path's N^3 products are products too; the kernels are
        # not (on the CPU their plain versions are, inside the kernel path's
        # autograd functions: their N^2 outputs only for the aggregate)
        assert any(map(n3, products)) == attention
    elif policy in ("proj", "tri_va") and attention:
        assert not any(n3(shape) for _, _, shape in saved)
    elif policy == "tri_a" and not dense:
        # the gated weights (b, j, h, i, k) of each direction
        assert [shape for _, _, shape in saved] == [(B, N, h, N, N)] * 4
    else:
        assert saved == []
    # forward kernel calls: 3 layers x 2 directions, plus the replay of
    # the 2 checkpointed layers unless tri_va saved their output
    replayed = 0 if policy == "tri_va" and attention else 4
    assert dense_calls[0] == (6 + replayed if attention and dense else 0)
    assert agg_calls[0] == (6 + replayed if not attention else 0)


def remat_equals_no_remat(policy, **extra):
    """Gradients under dropout with remat and ``policy`` equal those
    without remat, in every bit."""
    batch = feed()
    grads = {}
    for remat_on in (False, True):
        cfg = TGTConfig(**COMMON, model_height=3, remat=remat_on,
                        remat_policy=policy, **DROPOUT, **extra)
        grads[remat_on] = port_outputs(cfg, batch, deterministic=False,
                                       seed=5)[1]
    return all(torch.equal(grads[True][k], g) for k, g in grads[False].items())


@pytest.mark.parametrize("path", ["attention-dense", "attention-plain",
                                  "aggregate-dense"])
@pytest.mark.parametrize("policy", ["dots", "tri_a", "proj", "tri_va"])
def test_generators_stay_inside_the_checkpoint(monkeypatch, policy, path):
    """Under every policy the replay draws the forward's masks (dropout,
    drop path, the dense core's seeds), because each layer application
    makes its generator inside the checkpointed function. The mutation,
    generators made once in the forward and reused, advanced, by the
    replay, breaks the equality: the test can see it."""
    assert remat_equals_no_remat(policy, **PATHS[path])
    made = {}

    def outside(layer, g, rate, deterministic, seeds, cache=None):
        gens = made.setdefault(id(layer), [
            torch.Generator().manual_seed(s) for s in seeds])
        with remat.policy_scope(cache):
            for gen in gens:
                g = layer(g, drop_path_rate=rate,
                          deterministic=deterministic, generator=gen)
        return g

    monkeypatch.setattr(encoder_module, "_apply_layer", outside)
    assert not remat_equals_no_remat(policy, **PATHS[path])


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        make_model("distance", TGTConfig(**COMMON, model_height=2,
                                         remat_policy="everything"),
                   device="cpu")


# -- IndivConfig ---------------------------------------------------------------

def indiv_kw(**extra):
    return dict(COMMON, model_height=3, use_pallas="dense", **INDIV, **extra)


@pytest.mark.parametrize("remat_policy", [None, "none", "tri_va"])
def test_indiv_forward_and_grads_match_tgt_tpu(remat_policy):
    kw = indiv_kw(remat=remat_policy is not None,
                  remat_policy=remat_policy or "none")
    cfg, jcfg = TGTConfig(**kw), JaxTGTConfig(**kw)
    assert cfg.has_indiv and cfg.layer_cfg(1).triplet_type == "aggregate"
    params = jax_init(jcfg, seed=3)
    assert len(params["encoder"]["indiv"]) == 3
    got = port_outputs(cfg, feed(), params)
    assert_matches_jax(got, jax_outputs(jcfg, params, feed()), cfg)
    # layer 2 has no triplet sub-layer, layer 1 aggregates with 4 heads
    model = make_model("distance", cfg, device="cpu")
    layers = model.encoder.TGT_layers
    assert not hasattr(layers[2], "tria")
    assert type(layers[1].tria).__name__ == "TripletAggregate"
    assert layers[1].tria.num_heads == 4 and layers[0].tria.num_heads == 2


def test_indiv_every_layer_is_checkpointed(monkeypatch):
    """Under IndivConfig every layer is checkpointed, the last one too, as
    tgt_tpu's unrolled path remats them: the replay calls the attention
    layer 0's forward kernel again (2 directions) unless tri_va saved its
    output, and the aggregate layer 1's always."""
    calls = {m: count_calls(monkeypatch, mod, name) for m, (mod, name) in {
        "dense": (td, "triplet_dense_fwd"),
        "aggregate": (ta, "triplet_aggregate_fwd")}.items()}
    for policy, replay in (("none", 1), ("tri_va", 0)):
        for c in calls.values():
            c[0] = 0
        port_outputs(TGTConfig(**indiv_kw(remat=True, remat_policy=policy)),
                     feed())
        # layer 0 attends (2 launches), layer 1 aggregates (2), layer 2 none
        assert calls["dense"][0] == 2 * (1 + replay)
        assert calls["aggregate"][0] == 2 * 2      # aggregate replays always


def test_indiv_weight_bridge_round_trips(tmp_path):
    kw = indiv_kw()
    cfg, jcfg = TGTConfig(**kw), JaxTGTConfig(**kw)
    init, _ = jax_make_model("distance")
    rs = np.random.RandomState(4)
    shapes = jax.eval_shape(functools.partial(init, cfg=jcfg),
                            jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: (rs.standard_normal(x.shape) * 0.2)
                          .astype(x.dtype), shapes)
    model = make_model("distance", cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    back = jax_params_from_state_dict(model.state_dict(), cfg)
    assert isinstance(back["encoder"]["indiv"], tuple)
    flat, want = ckpt.flatten_tree(back), ckpt.flatten_tree(np_tree(params))
    assert list(flat) == list(want)      # jax's order: layers 0, 1, 2
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    # tgt_tpu's converter reads the port's state_dict
    again = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, params, jcfg)
    for k, v in ckpt.flatten_tree(np_tree(again)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # the port's checkpoint loads strictly in tgt_tpu, and back in the port
    ckpt.save_pytree(back, str(tmp_path / "model.npz"))
    loaded, missing, unexpected = jckpt.load_pytree(
        shapes, str(tmp_path / "model.npz"))
    assert missing == unexpected == []
    for k, v in ckpt.flatten_tree(np_tree(loaded)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    jckpt.save_pytree(loaded, str(tmp_path / "ref.npz"))
    ours, missing, unexpected = ckpt.load_pytree(back, str(tmp_path / "ref.npz"))
    assert missing == unexpected == [] and isinstance(
        ours["encoder"]["indiv"], tuple)
    from tgt_torch.models.convert import load_jax_npz
    model.load_state_dict(state_dict_from_jax_params(
        load_jax_npz(str(tmp_path / "ref.npz")), cfg))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, state_dict_from_jax_params(
            back, cfg)[k], rtol=0, atol=0)


def test_yaml_lists_reach_the_encoder(tmp_path):
    over = dict(dataset_source="synthetic", synth_train_samples=8,
                synth_max_nodes=10, batch_size=4, buckets=[12],
                model_height=3, node_width=16, edge_width=8, num_heads=4,
                triplet_heads=[2, 4, 0],
                triplet_type=["attention", "aggregate", "aggregate"],
                num_dist_bins=8, use_pallas="dense", remat=True,
                remat_policy="tri_va", save_path_prefix=str(tmp_path))
    scheme = get_scheme("pcqm.dist_pred")(over)
    jscheme = jax_get_scheme("pcqm.dist_pred")(dict(over, use_mesh=False))
    assert scheme.model_cfg.triplet_type == jscheme.model_cfg.triplet_type
    assert scheme.model_cfg.has_indiv
    model = scheme.init_model(0, "cpu")
    host = next(iter(scheme.train_loader(0, 0, 1)))
    db = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in scheme.device_batch(host).items()}
    loss, _ = scheme.loss_fn(model, db, seed=0)
    loss.backward()
    assert torch.isfinite(loss) and all(
        p.grad is not None for p in model.parameters())
