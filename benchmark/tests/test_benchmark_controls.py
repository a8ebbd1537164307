"""`correct` comes out false where it should: the control (the reference at the
next precision below the configuration's, in the program's place) fails the
comparison, and a run with the timed path broken underneath reads false, once
for each fault the cells can have. The runs skip the harness's look for a chip
and drive the rest on the CPU at a tiny size."""

from __future__ import annotations

import pytest
import torch

from bench_tiny import SERVE, UNET, bench, execute, tree

from benchmark.core import sampled, serving, spec


def _placed(cfg, tr, seed):
    reqs = serving.requests(tr["max_batch"], cfg["frames"], cfg["njoints"], seed, tr["keyframes"])
    return [sampled.Placed(reqs[0]["noise_seed"], tr["max_batch"], i, torch.from_numpy(r["text"]),
                           torch.from_numpy(r["obs_x0"]), torch.from_numpy(r["obs_mask"]))
            for i, r in enumerate(reqs)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_fails_the_serving_comparison(seed):
    placed = _placed(UNET, SERVE, seed)
    want = sampled.reference_motions(UNET, seed, "bf16", placed, 2.5, "cpu")
    got = sampled.reference_motions(UNET, seed, "bf16", placed, 2.5, "cpu", precision="fp8")
    assert float(sampled.rel_rms(got, want).max()) > 10 * SERVE["check"]["limit"]


@pytest.mark.cuda
def test_tf32_control_fails_the_offline_comparison():
    """TF32 acts on the card only: the float32 offline cell's control."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 products exist only on the card")
    from bench_tiny import MDM, OFFLINE

    placed = [sampled.Placed(5, 4, i, torch.randn(512)) for i in range(4)]
    cfg = dict(MDM, latent_dim=512, ff_size=1024, layers=8, card_overrides={})
    want = sampled.reference_motions(cfg, 3, "f32", placed, 2.5, "cuda")
    got = sampled.reference_motions(cfg, 3, "f32", placed, 2.5, "cuda", precision="tf32")
    assert float(sampled.rel_rms(got, want).max()) > OFFLINE["check"]["limit"]


def test_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch):
    from condmdi_tpu_torch.sampling import pipeline

    sample = pipeline.SamplePipeline.sample

    def altered(self, *a, **kw):
        return sample(self, *a, **kw) * 1.05

    monkeypatch.setattr(pipeline.SamplePipeline, "sample", altered)
    for cell in ("tiny.serve_kf", "tiny.offline"):
        assert not execute(tree(tmp_path / cell), cell)["correct"]


def test_a_step_that_leaves_its_state_unchanged(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    result = execute(tree(tmp_path), "tiny.train")
    assert not result["correct"]
    assert result["checks"]["param_change_leaf_gap_max"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(tmp_path, monkeypatch):
    from condmdi_tpu_torch.training import loop

    losses = loop.training_losses

    def half(*a, **kw):
        terms = losses(*a, **kw)
        per = terms["loss"]
        B = per.shape[0] // 2
        terms["loss"] = torch.cat([per[:B], per[:B]])  # the mean over the first half
        return terms

    monkeypatch.setattr(loop, "training_losses", half)
    assert not execute(tree(tmp_path), "tiny.train")["correct"]


def test_readings_apply_the_committed_limits(tmp_path):
    """controls.py reads the program's check steps and the planted half-batch fault
    as a run does, and judges each by the cell's committed limits."""
    from benchmark import controls

    cell = spec.load_cell(bench(), "tiny.train", tree(tmp_path))
    readings = {r["reading"]: r for r in controls.train_readings(cell, 7, "cpu", True, True)}
    assert readings["program"]["correct"]
    assert not readings["fault half_batch"]["correct"]
    assert readings["program"]["limits"] == {
        "loss_rel_gap_max": 1e-4, "first_grad_leaf_gap_max": 1e-3,
        "param_change_leaf_gap_max": 1e-3}
