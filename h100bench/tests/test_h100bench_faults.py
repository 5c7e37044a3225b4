"""A run with its timed path broken underneath comes out not correct,
once for each fault the cell can have, and so does the control (the
reference in float8 against itself in float32): at the tiny preset on the
CPU, the harness's look for a card skipped, under the cells' own limits."""
from __future__ import annotations

import pytest
import torch

from h100bench import calibrate
from h100bench.yardstick import compare
from h100bench.reference import model as ref_model
from h100bench.tests import tiny


def _frozen_step(self, state, batch, step, seed, lr_scale=1.0):
    """A step that computes its loss and returns its state unchanged."""
    loss, _, _ = self.accumulated_grad(state["model"], batch, seed)
    return state, {"loss": loss.detach(), "lr": 0.0,
                   "ok": torch.isfinite(loss)}


def _rolled(original):
    def mc_forward(self, feed, seeds):
        return original(self, feed, seeds).roll(1, dims=-1)
    return mc_forward


def test_sound_runs_are_correct():
    for cell in (tiny.TRAIN, tiny.SERVE):
        assert tiny.run(cell)["result"]["correct"], cell


def test_state_returned_unchanged(monkeypatch):
    from tgt_torch.training.harness import Trainer
    monkeypatch.setattr(Trainer, "train_step", _frozen_step)
    assert not tiny.run(tiny.TRAIN)["result"]["correct"]


def test_half_of_the_batch_left_out():
    undo = calibrate.half_batch_fault()
    try:
        assert not tiny.run(tiny.TRAIN)["result"]["correct"]
    finally:
        undo()


def test_answer_altered_where_produced(monkeypatch):
    from tgt_torch.serving import DistancePredictor
    monkeypatch.setattr(DistancePredictor, "_mc_forward",
                        _rolled(DistancePredictor._mc_forward))
    assert not tiny.run(tiny.SERVE)["result"]["correct"]


@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.SERVE])
def test_control_is_not_correct(cell):
    """The program against the float8 reference reads what the float8
    reference reads against the float32 one."""
    rec = tiny.run(cell, reference_cast=ref_model.fp8_cast)
    assert not rec["result"]["correct"]


def test_a_fault_in_one_leaf_of_the_first_gradient_is_caught():
    """grad_gap is the worst leaf's, but for the Gaussian basis of the 3D
    embedding, whose gaps are kept apart."""
    names = [f"encoder.TGT_layers.{i}.tria.lin_EG_in.weight"
             for i in range(20)]
    names.append("input_embed.m3d_embed.gbf.means.weight")
    ref = {"losses": [1.0], "grad_norms": dict.fromkeys(names, 1.0),
           "change_norms": dict.fromkeys(names, 1.0)}
    prog = {k: dict(v) if isinstance(v, dict) else list(v)
            for k, v in ref.items()}
    prog["grad_norms"][names[-1]] = 1.3
    assert compare.training(prog, ref)["grad_gap"] == 0.0
    assert compare.training_details(prog, ref)["grad_norms"][
        "set_aside"] == pytest.approx(0.3)
    prog["grad_norms"][names[3]] = 1.01
    assert compare.training(prog, ref)["grad_gap"] == pytest.approx(0.01)


def test_a_changed_draw_layout_fails_only_where_masks_are_drawn(monkeypatch):
    """Padding each request to twice the rows changes the masks the draws
    give the molecule's row: the served answers fail, and the same
    requests with every dropout off still agree."""
    from tgt_torch.serving import DistancePredictor
    init = DistancePredictor.__init__

    def padded_wider(self, *args, **kwargs):
        kwargs["batch_size"] = 2 * kwargs["batch_size"]
        init(self, *args, **kwargs)

    monkeypatch.setattr(DistancePredictor, "__init__", padded_wider)
    rec = tiny.run(tiny.SERVE)
    assert not rec["result"]["correct"]
    assert rec["numbers"]["prob_gap_rate0"] < 1e-5
