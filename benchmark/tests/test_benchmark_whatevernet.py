"""``whatevernet.train`` at tiny size on the CPU: the semi-supervised cell's
rehearsal is correct and reports its metrics, its traced run reads the
loader's unlabeled items, and a step whose loss leaves out the consistency
term is not correct."""

from __future__ import annotations

from benchmark import run

CELL = "whatevernet.train"


def test_rehearsal_is_correct_and_reports_its_metrics(tiny_cell):
    cell = tiny_cell(CELL)
    assert cell.config["regime"] == "semisupervised"
    line = run.run_cell(cell)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_patches_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())


def test_traced_rehearsal_reads_the_unlabeled_items(tiny_cell):
    line = run.run_cell(tiny_cell(CELL, trace=True))
    assert line["correct"], line["checks"]
    assert line["metrics"]["train.assemble_unlabeled_ms"]["value"] > 0
    # an unlabeled item is part of its batch's assembly
    assert (line["metrics"]["train.assemble_unlabeled_ms"]["value"]
            < line["metrics"]["train.assemble_ms"]["value"])


def test_consistency_left_out_is_not_correct(tiny_cell, monkeypatch):
    """The step's loss is the supervised term alone: the checked steps hold
    unlabeled rows, whose loss then differs."""
    from multimodal_siamese_cd_tpu_torch import train_lib

    make_step = train_lib._make_step

    def without_consistency(model, optimizer, cfg, losses_of):
        def losses(*args):
            metrics = losses_of(*args)
            return {**metrics, "loss": metrics["sup_loss"]}
        return make_step(model, optimizer, cfg, losses)

    monkeypatch.setattr(train_lib, "_make_step", without_consistency)
    line = run.run_cell(tiny_cell(CELL))
    assert not line["correct"]
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]
