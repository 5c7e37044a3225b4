"""tgt_torch's training slice against tgt_tpu (CPU, float32).

A 2-layer TGT-At distance model (node and edge width 64, 8 heads, 4 triplet
heads, buckets of 16 nodes, every dropout rate 0) with the weights of
tgt_tpu's init, mapped through ``state_dict_from_jax_params``:
- ``discrete_dist_loss`` to 1e-6;
- ``DistPredScheme.loss_fn``: loss to 1e-5, every parameter's gradient to
  1e-4 of its max|ref|, against ``jax.value_and_grad`` of tgt_tpu's;
- the optimizers on identical gradients to 1e-6, the schedules to 1e-7,
  ``resolve_grad_accum``'s error cases;
- three ``Trainer`` steps with accumulation 2 against tgt_tpu's Trainer on
  the same synthetic batches: losses to 1e-4 relative, parameters within
  1e-3 of the summed learning rates (the triplet biases that shift a whole
  softmax row, whose gradient is zero in exact arithmetic, within them);
- with dropout and drop path on, gradients with remat equal those without
  under the same seed, also at ``layer_multiplier=2`` (attention, aggregate
  with triplet dropout, and dense attention with its in-core triplet
  dropout); the NaN-step guard; an all-padding micro-batch;
- ``layer_multiplier=2`` with and without remat: deterministic logits to
  1e-4 of max|ref|, loss and gradients as above, against tgt_tpu;
- the data path: the synthetic molecules, the train loader's batches and
  the device batches equal tgt_tpu's, key by key, over epochs and ranks.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgt_tpu.schemes import get_scheme as jax_get_scheme
from tgt_tpu.schemes.commons import coords2dist as jax_coords2dist
from tgt_tpu.schemes.commons import discrete_dist_loss as jax_dd_loss
from tgt_tpu.training import harness as jharness
from tgt_tpu.training import schedules as jschedules
from tgt_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from tgt_torch.data.prepare import write_synthetic_dataset
from tgt_torch.data.synthetic import SyntheticDataset
from tgt_torch.models.convert import state_dict_from_jax_params
from tgt_torch.schemes import get_scheme
from tgt_torch.schemes.commons import add_coords_noise, discrete_dist_loss
from tgt_torch.training import Trainer, make_optimizer, resolve_grad_accum
from tgt_torch.training import schedules

torch.set_num_threads(1)

SMALL = dict(
    dataset_source="synthetic", synth_train_samples=24, synth_max_nodes=14,
    batch_size=4, buckets=[16], model_height=2, node_width=64, edge_width=64,
    num_heads=8, triplet_heads=4, triplet_type="attention", num_dist_bins=16,
    use_pallas="dense", max_lr=1e-3, min_lr=1e-6, lr_warmup_steps=1,
    lr_total_steps=100)
DROPOUT = dict(source_dropout=0.3, drop_path=0.4, node_act_dropout=0.2,
               edge_act_dropout=0.2)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def schemes(tmp_path, **extra):
    over = dict(SMALL, save_path_prefix=str(tmp_path), **extra)
    return (jax_get_scheme("pcqm.dist_pred")(dict(over, use_mesh=False)),
            get_scheme("pcqm.dist_pred")(over))


def port_model(scheme, params):
    """The port's model on the CPU with tgt_tpu's weights."""
    model = scheme.init_model(0, "cpu")
    model.load_state_dict(state_dict_from_jax_params(np_tree(params),
                                                     scheme.model_cfg))
    return model


def softmax_shift_entries(name, cfg):
    """The entries of a triplet bias that add one value to every logit of a
    softmax row (the key bias of lin_QKV_{in,out}, the per-head bias of
    lin_EG_{in,out}): their gradient is zero in exact arithmetic, so both
    sides hold float noise, which Adam turns into steps of up to lr."""
    if ".tria.lin_QKV_" in name and name.endswith(".bias"):
        return slice(cfg.edge_width, 2 * cfg.edge_width)
    if ".tria.lin_EG_" in name and name.endswith(".bias"):
        return slice(0, cfg.triplet_heads)
    return None


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def first_batch(jscheme):
    host = next(iter(jscheme.train_loader(0, 0, 1)))
    return jscheme.device_batch(host)


def assert_grads_close(model, jgrads, cfg, rel=1e-4):
    ref = state_dict_from_jax_params(np_tree(jgrads), cfg)
    names = dict(model.named_parameters())
    assert set(names) == set(ref)
    for name, p in names.items():
        r = ref[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=rel * np.abs(r).max(), err_msg=name)


def assert_remat_equals_no_remat(tmp_path, **extra):
    """Gradients of one stochastic loss with remat equal those without, bit
    for bit, under the same seed; another seed changes them."""
    grads = {}
    for remat, seed in ((False, 5), (True, 5), (False, 6)):
        _, scheme = schemes(tmp_path, remat=remat, **extra)
        model = scheme.init_model(0, "cpu")
        db = tensors(scheme.device_batch(
            next(iter(scheme.train_loader(0, 0, 1)))))
        loss, _ = scheme.loss_fn(model, db, seed=seed)
        loss.backward()
        grads[remat, seed] = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads[False, 5].items():
        torch.testing.assert_close(grads[True, 5][k], g, rtol=0, atol=0)
    assert any(not torch.equal(grads[False, 6][k], g)
               for k, g in grads[False, 5].items())   # masks matter


class TestLoss:
    @pytest.mark.parametrize("reduce", [True, False])
    def test_discrete_dist_loss(self, reduce):
        rs = np.random.RandomState(0)
        logits = rs.randn(3, 10, 10, 32).astype(np.float32)
        dist = np.abs(rs.randn(3, 10, 10)).astype(np.float32) * 5.0
        mask = (rs.rand(3, 10, 10) > 0.3).astype(np.float32)
        got = discrete_dist_loss(*(torch.from_numpy(x) for x in
                                   (logits, dist, mask)), 32, 8.0,
                                 reduce=reduce)
        want = jax_dd_loss(*(jnp.asarray(x) for x in (logits, dist, mask)),
                           32, 8.0, reduce=reduce)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)

    def test_add_coords_noise(self):
        """The smoothing of tgt_tpu's add_coords_noise on the same noise
        (PyTorch draws it: the generators differ by design)."""
        rs = np.random.RandomState(2)
        coords = rs.randn(2, 6, 3).astype(np.float32)
        em = np.ones((2, 6, 6), np.float32)
        em[1, 4:, :] = em[1, :, 4:] = 0
        got = add_coords_noise(torch.from_numpy(coords), torch.from_numpy(em),
                               0.2, 1.5, torch.Generator().manual_seed(3))
        noise = torch.randn(coords.shape, generator=torch.Generator()
                            .manual_seed(3)).numpy() * 0.2
        dist = np.asarray(jax_coords2dist(jnp.asarray(coords))) + (1 - em) * 1e9
        smooth = np.asarray(jax.nn.softmax(-dist / 1.5, axis=-1))
        np.testing.assert_allclose(got.numpy(), coords + smooth @ noise,
                                   rtol=1e-5, atol=1e-6)

    def test_loss_fn_value_and_grads(self, tmp_path):
        jscheme, scheme = schemes(tmp_path)
        params = jscheme.init_params(jax.random.PRNGKey(0))
        db = first_batch(jscheme)
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jscheme.loss_fn(p, {k: jnp.asarray(v)
                                          for k, v in db.items()},
                                      jax.random.PRNGKey(1)),
            has_aux=True))(params)
        model = port_model(scheme, params)
        loss, aux = scheme.loss_fn(model, tensors(db), seed=1)
        assert aux == {}
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        assert_grads_close(model, jgrads, scheme.model_cfg)


OPTIMIZERS = {
    "adam": dict(optimizer="adam"),
    "adam_l2": dict(optimizer="adam", weight_decay=0.01),
    "adamw": dict(optimizer="adamw", weight_decay=0.01),
    "sgd": dict(optimizer="sgd", sgd_momentum=0.9),
    "clip_value": dict(optimizer="adam", clip_grad_value=0.5),
    "clip_norm": dict(optimizer="adam", clip_grad_norm=1.0),
}


class TestOptimizerAndSchedules:
    @pytest.mark.parametrize("name", list(OPTIMIZERS))
    def test_update_matches_tgt_tpu(self, tmp_path, name):
        jscheme, scheme = schemes(tmp_path, **OPTIMIZERS[name])
        rs = np.random.RandomState(1)
        params = {"a": rs.randn(5, 3).astype(np.float32),
                  "b": rs.randn(7).astype(np.float32)}
        jinit, jupdate = jharness.make_optimizer(jscheme.cfg, None)
        init, update = make_optimizer(scheme.cfg)
        jstate = jinit({k: jnp.asarray(v) for k, v in params.items()})
        state = init({k: torch.from_numpy(v) for k, v in params.items()})
        for step, lr in enumerate((1e-3, 5e-4)):
            grads = {k: (rs.randn(*v.shape) * 2).astype(np.float32)
                     for k, v in params.items()}
            jup, jstate = jupdate({k: jnp.asarray(v) for k, v in
                                   grads.items()}, jstate,
                                  {k: jnp.asarray(v) for k, v in
                                   params.items()}, lr)
            up, state = update({k: torch.from_numpy(v) for k, v in
                                grads.items()}, state,
                               {k: torch.from_numpy(v) for k, v in
                                params.items()}, lr)
            for k in params:
                np.testing.assert_allclose(up[k].numpy(), np.asarray(jup[k]),
                                           rtol=1e-6, atol=1e-9)
                for mom in ("mu", "nu"):
                    if mom in jstate:
                        np.testing.assert_allclose(
                            state[mom][k].numpy(),
                            np.asarray(jstate[mom][k]), rtol=1e-6, atol=1e-9)
            assert int(state["count"]) == int(jstate["count"]) == step + 1
            params = {k: v + np.asarray(jup[k]) for k, v in params.items()}

    def test_unknown_optimizer_raises(self, tmp_path):
        _, scheme = schemes(tmp_path, optimizer="lamb")
        with pytest.raises(ValueError, match="unknown optimizer"):
            make_optimizer(scheme.cfg)

    @pytest.mark.parametrize("kind", ["cosine", "halfwave", "linear",
                                      "constant"])
    def test_schedules(self, kind):
        make = {
            "cosine": lambda m: m.warmup_cosine(1e-3, 10, 100, 1e-6),
            "halfwave": lambda m: m.warmup_cosine(1e-3, 10, 100, 1e-6, True),
            "linear": lambda m: m.warmup_linear(5e-4, 20),
            "constant": lambda m: m.constant(2e-4),
        }[kind]
        ours, ref = make(schedules), make(jschedules)
        for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
            assert abs(ours(step) - float(ref(step))) <= 1e-7, step

    def test_resolve_grad_accum(self, tmp_path):
        for extra, world in ((dict(global_batch_size=16), 1),
                             (dict(global_batch_size=16), 2),
                             (dict(grad_accum_steps=3), 1),
                             (dict(global_batch_size=16,
                                   grad_accum_steps=4), 1)):
            jscheme, scheme = schemes(tmp_path, **extra)
            assert resolve_grad_accum(scheme.cfg, world) == \
                jharness.resolve_grad_accum(jscheme.cfg, world)
        _, scheme = schemes(tmp_path, batch_size=5, global_batch_size=16)
        with pytest.raises(ValueError, match="not a multiple"):
            resolve_grad_accum(scheme.cfg, 1)
        _, scheme = schemes(tmp_path, global_batch_size=16,
                            grad_accum_steps=2)
        with pytest.raises(ValueError, match="contradicts"):
            resolve_grad_accum(scheme.cfg, 1)


class TestTrainer:
    def test_three_steps_match_tgt_tpu(self, tmp_path):
        jscheme, scheme = schemes(tmp_path, global_batch_size=8)
        jtrainer = jharness.Trainer(jscheme)
        trainer = Trainer(scheme, device="cpu")
        assert trainer.grad_accum == jtrainer.grad_accum == 2
        jstate = jtrainer.init_state(jax.random.PRNGKey(0))
        state = trainer.init_state()
        state["model"].load_state_dict(state_dict_from_jax_params(
            np_tree(jstate["params"]), scheme.model_cfg))
        jstep = jtrainer.build_train_step()
        lr_sum = 0.0
        batches = list(jscheme.train_loader(0, 0, 1))
        assert len(batches) == 3            # 24 molecules, 8 per step
        for i, host in enumerate(batches):
            db = jscheme.device_batch(host)
            jstate, jm = jstep(jstate, jtrainer.shard_device_batch(db),
                               jnp.asarray(i), jax.random.PRNGKey(i),
                               jnp.asarray(1.0))
            state, m = trainer.train_step(
                state, trainer.to_device(trainer.pad_device_batch(db)), i,
                seed=i)
            assert bool(m["ok"]) and bool(jm["ok"])
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=1e-4)
            assert abs(m["lr"] - float(jm["lr"])) <= 1e-9
            lr_sum += m["lr"]
            ref = state_dict_from_jax_params(np_tree(jstate["params"]),
                                             scheme.model_cfg)
            for k, v in state["model"].state_dict().items():
                # 1e-3 of the learning rate per step, plus one f32 rounding
                # of the parameter per step (the step-0 warmup lr is 1e-6)
                r = ref[k].numpy()
                bound = 1e-3 * lr_sum + (i + 1) * np.spacing(np.abs(r))
                shift = softmax_shift_entries(k, scheme.model_cfg)
                if shift is not None:
                    bound[shift] += lr_sum
                err = np.abs(v.numpy() - r)
                assert np.all(err <= bound), (k, float(err.max()))
        assert int(state["opt_state"]["count"]) == 3

    def test_train_epoch_moves_params_and_counts_steps(self, tmp_path):
        _, scheme = schemes(tmp_path, global_batch_size=8)
        trainer = Trainer(scheme, device="cpu")
        state = trainer.init_state()
        before = {k: v.clone() for k, v in state["model"].state_dict().items()}
        state, logs, stop = trainer.train_epoch(
            state, scheme.train_loader(0, 0, 1))
        assert stop is None and trainer.global_step == 3
        assert np.isfinite(logs["loss"]) and logs["lr"] > 0
        after = state["model"].state_dict()
        assert all(not torch.equal(before[k], after[k]) for k in before)

    def test_remat_gradients_equal_without_remat_under_dropout(self, tmp_path):
        """checkpoint replays each layer's forward in the backward; the
        layer's generator is made inside the replayed function, so the
        replay draws the forward's masks and the gradients are the same."""
        assert_remat_equals_no_remat(tmp_path, model_height=3, **DROPOUT)

    def test_nan_loss_leaves_params_and_moments(self, tmp_path):
        _, scheme = schemes(tmp_path)
        trainer = Trainer(scheme, device="cpu")
        state = trainer.init_state()
        db = scheme.device_batch(next(iter(scheme.train_loader(0, 0, 1))))
        state, m = trainer.train_step(state, trainer.to_device(db), 0, 0)
        assert bool(m["ok"])
        params = {k: v.clone() for k, v in state["model"].state_dict().items()}
        opt = jax.tree.map(lambda t: t.clone(), state["opt_state"])
        db["rdkit_coords"] = np.full_like(db["rdkit_coords"], np.nan)
        state, m = trainer.train_step(state, trainer.to_device(db), 1, 1)
        assert not bool(m["ok"]) and not np.isfinite(float(m["loss"]))
        for k, v in state["model"].state_dict().items():
            assert torch.equal(v, params[k]), k
        for a, b in zip(jax.tree.leaves(state["opt_state"]),
                        jax.tree.leaves(opt)):
            assert torch.equal(a, b)

    def test_all_padding_micro_batch_adds_nothing(self, tmp_path):
        """A batch of 4 real molecules padded to 8 under accumulation 2:
        the second micro-batch is all padding and weighs 0, so loss and
        gradients equal one pass over the 4 real molecules."""
        _, scheme = schemes(tmp_path, batch_size=4, grad_accum_steps=2)
        trainer = Trainer(scheme, device="cpu")
        model = trainer.init_state()["model"]
        db = scheme.device_batch(next(iter(scheme.train_loader(0, 0, 1))))
        half = {k: v[:4] for k, v in db.items()}
        padded = {k: np.concatenate([v, np.zeros_like(v)]) for k, v in
                  half.items()}
        loss2, _, g2 = trainer.accumulated_grad(model, tensors(padded), 0)
        trainer.grad_accum = 1
        loss1, _, g1 = trainer.accumulated_grad(model, tensors(half), 0)
        assert padded["sample_mask"][4:].sum() == 0
        torch.testing.assert_close(loss2, loss1, rtol=1e-6, atol=0)
        for a, b in zip(g2, g1):
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=1e-6 * float(b.abs().max()))

    def test_uneven_batch_pads_to_the_accumulation(self, tmp_path):
        _, scheme = schemes(tmp_path, batch_size=6, grad_accum_steps=3)
        trainer = Trainer(scheme, device="cpu")
        db = scheme.device_batch(next(iter(scheme.train_loader(0, 0, 1))))
        db = {k: v[:16] for k, v in db.items()}
        padded = trainer.pad_device_batch(db)
        assert {v.shape[0] for v in padded.values()} == {18}
        assert padded["sample_mask"].sum() == db["sample_mask"].sum()

    @staticmethod
    def assert_train_batches_equal(jscheme, scheme, epochs=(0, 1)):
        for epoch in epochs:
            got = list(scheme.train_loader(epoch, 0, 1))
            want = list(jscheme.train_loader(epoch, 0, 1))
            assert len(got) == len(want) > 0
            for i, (g, w) in enumerate(zip(got, want)):
                assert_arrays_equal(g, w, f"epoch {epoch} host batch {i}")
        return len(got)

    # The two tests below asserted the NotImplementedError these features
    # raised before they were ported; they keep their names and now assert
    # that the features work.
    def test_pcqm_source_is_not_ported(self, tmp_path):
        """``dataset_source: pcqm``: its train loader gives tgt_tpu's
        batches over epochs 0 and 1."""
        data = str(tmp_path / "data")
        write_synthetic_dataset(data, num_samples=40, max_nodes=14, seed=1)
        jscheme, scheme = schemes(tmp_path, dataset_source="pcqm",
                                  dataset_path=data, global_batch_size=8)
        # train-3d: 27 molecules
        assert self.assert_train_batches_equal(jscheme, scheme) == 4

    def test_size_bucketed_batching_is_not_ported(self, tmp_path):
        """``size_bucketed_batching``: the same batches as tgt_tpu's over
        epochs 0 and 1, from synthetic molecules and from PCQM parquet."""
        jscheme, scheme = schemes(tmp_path, size_bucketed_batching=True,
                                  buckets=[8, 12, 16], global_batch_size=8)
        # a bucket's remainder batches
        assert self.assert_train_batches_equal(jscheme, scheme) > 3
        data = str(tmp_path / "data")
        write_synthetic_dataset(data, num_samples=40, max_nodes=14, seed=1)
        jscheme, scheme = schemes(tmp_path, dataset_source="pcqm",
                                  dataset_path=data, global_batch_size=8,
                                  size_bucketed_batching=True,
                                  buckets=[6, 10, 14])
        self.assert_train_batches_equal(jscheme, scheme)


class TestLayerMultiplier:
    """``layer_multiplier=2`` (each layer applied twice, as every TGT-Agx2
    config runs), on the attention variant."""

    @pytest.mark.parametrize("remat", [True, False],
                             ids=["remat", "no_remat"])
    def test_logits_and_grads_match_tgt_tpu(self, tmp_path, remat):
        jscheme, scheme = schemes(tmp_path, layer_multiplier=2, remat=remat)
        params = jscheme.init_params(jax.random.PRNGKey(2))
        db = first_batch(jscheme)
        model = port_model(scheme, params)
        batch = tensors(db)
        feed = scheme._model_inputs(batch, scheme.edge_mask_of(batch),
                                    torch.Generator())
        with torch.no_grad():
            logits = model(feed, deterministic=True).numpy()
        ref = np.asarray(jscheme.apply_model(
            params, {k: jnp.asarray(v.numpy()) for k, v in feed.items()},
            deterministic=True))
        np.testing.assert_allclose(logits, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jscheme.loss_fn(p, {k: jnp.asarray(v)
                                          for k, v in db.items()},
                                      jax.random.PRNGKey(1)),
            has_aux=True))(params)
        loss, _ = scheme.loss_fn(model, batch, seed=1)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        assert_grads_close(model, jgrads, scheme.model_cfg)

    @pytest.mark.parametrize("triplet_type,extra", [
        pytest.param("attention", {}, id="attention"),
        pytest.param("aggregate", dict(triplet_dropout=0.2), id="aggregate"),
        pytest.param("attention", dict(triplet_dropout=0.2,
                                       use_pallas="dense"),
                     id="attention-dense-dropout")])
    def test_remat_gradients_equal_without_remat_under_dropout(
            self, tmp_path, triplet_type, extra):
        """Each application of a layer draws from its own generator, made
        inside the checkpointed function; the aggregate case also drops
        triplet weights, and the dense attention case draws its in-core
        dropout seeds from that generator, so the remat replay rebuilds the
        same keep masks."""
        assert_remat_equals_no_remat(tmp_path, model_height=2,
                                     layer_multiplier=2,
                                     triplet_type=triplet_type,
                                     **DROPOUT, **extra)


def assert_arrays_equal(got, want, where):
    assert set(got) == set(want), where
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (where, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


class TestDataPath:
    """The port's data path against tgt_tpu's on the same synthetic config:
    23 molecules, so that the last batch is short and rank 1 of 2 wrap-pads;
    ``global_batch_size=8`` gives host batches of 8 on one rank and of 4 on
    each of two."""

    def test_synthetic_molecules_match(self):
        got = SyntheticDataset(num_samples=23, max_nodes=14, seed=0)
        want = JaxSyntheticDataset(num_samples=23, max_nodes=14, seed=0)
        assert len(got) == len(want)
        for i in range(len(want)):
            assert_arrays_equal(got[i], want[i], f"row {i}")

    @pytest.mark.parametrize("epoch,rank,world_size",
                             [(0, 0, 1), (1, 0, 1), (0, 0, 2), (0, 1, 2),
                              (1, 0, 2), (1, 1, 2)])
    def test_train_loader_and_device_batch_match(self, tmp_path, epoch, rank,
                                                 world_size):
        jscheme, scheme = schemes(tmp_path, synth_train_samples=23,
                                  global_batch_size=8)
        got = list(scheme.train_loader(epoch, rank, world_size))
        want = list(jscheme.train_loader(epoch, rank, world_size))
        assert len(got) == len(want) == 3
        for i, (g, w) in enumerate(zip(got, want)):
            assert_arrays_equal(g, w, f"host batch {i}")
            assert scheme.batch_num_samples(g) == jscheme.batch_num_samples(w)
            assert_arrays_equal(scheme.device_batch(g), jscheme.device_batch(w),
                                f"device batch {i}")

    @pytest.mark.parametrize("coords_input,coords_target",
                             [("rdkit", "dft"), ("dft", "dft"),
                              ("none", "dft"), ("rdkit", "rdkit")])
    def test_device_keys_match(self, tmp_path, coords_input, coords_target):
        jscheme, scheme = schemes(tmp_path, coords_input=coords_input,
                                  coords_target=coords_target)
        assert list(scheme.device_keys()) == list(jscheme.device_keys())
        host = next(iter(jscheme.train_loader(0, 0, 1)))
        db = scheme.device_batch(host)
        assert_arrays_equal(db, jscheme.device_batch(host), "device batch")
        assert {f"{coords_target}_coords", "sample_mask"} <= set(db)
