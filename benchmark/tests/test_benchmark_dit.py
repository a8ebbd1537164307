"""The DiT reference (reference/dit.py) and the offline driver with keyframes and
the DiT's census (drivers/offline_batch_ext.py), on the CPU at tiny sizes: the
reference against the port, its FLOPs against a hand count, two tiny cells run
end to end, and the readers of what the driver adds."""

from __future__ import annotations

import json
import time

import pytest
import torch

from bench_tiny import E2E, tree

from benchmark import run as bench_run
from benchmark.core import program, spec
from benchmark.counts import models

# head width 12: neither a multiple of 16 nor a width the resident kernels take
DIT = dict(card="motion_mdm",
           card_overrides=dict(arch="dit_prenorm", latent_dim=48, ff_size=96, layers=2,
                               num_heads=4, diffusion_steps=20),
           reference="dit", njoints=263, latent_dim=48, ff_size=96, layers=2, heads=4,
           clip_dim=512, frames=12, diffusion_steps=20)
EXT = dict(driver="offline_batch_ext", precision="f32", batch=3, guidance=2.5, frames=12,
           keyframes=None, check=dict(requests=3, limit=1e-3))
CELLS = {"tiny.offline_kf": ("tiny_unet", "tiny_offline_kf"),
         "tiny.offline_dit": ("tiny_dit", "tiny_offline_dit")}


def ext_tree(tmp):
    root = tree(tmp)
    for name, body in (("configs/tiny_dit", DIT),
                       ("traffic/tiny_offline_kf", dict(EXT, keyframes=[2, 5])),
                       ("traffic/tiny_offline_dit", EXT)):
        (root / f"{name}.json").write_text(json.dumps(body))
    return root


def ext_bench() -> dict:
    e2e = [dict(m, workloads=list(CELLS)) if m["name"] == "samples_per_s" else m for m in E2E]
    return dict(workloads=[dict(name=n, config=c, traffic=t, chips=1, why="a test")
                           for n, (c, t) in CELLS.items()], end_to_end=e2e, per_layer=[])


def _inputs(B=3, T=12, F=263):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((B, T, F), generator=g), torch.tensor([3, 500, 999]),
            torch.randn((B, 512), generator=g), torch.tensor([False, True, False]))


@pytest.mark.parametrize("heads", [4, 3], ids=["hd12", "hd16"])
def test_dit_reference_matches_the_port(heads):
    """MDM_DiT dit_prenorm against reference/dit.py on the seed's weights, float32:
    within 1e-5 of the output's scale, float32 rounding through two blocks whose
    sums run in another order (the port's LayerNorm and attention are torch's)."""
    cfg = dict(DIT, heads=heads, card_overrides=dict(DIT["card_overrides"], num_heads=heads))
    model, *_ = program.build(cfg, 11, "cpu", "f32")
    ref = program.reference_module(cfg).Model(program.make_weights(cfg, 11, "cpu", "f32"), cfg)
    x, t, text, uncond = _inputs()
    with torch.no_grad():
        got = model(x, t, {"text_embed": text, "uncond": uncond})
    want = ref(x, t, text, uncond)
    assert want.abs().max() > 0.1
    assert (got - want).abs().max() <= 1e-5 * (1 + want.abs().max())


@pytest.mark.parametrize("precision", ["bf16", "fp8"])
def test_dit_reference_rounds_its_products(precision):
    """A control's precision reaches every product: the reference at bf16 or fp8
    operands moves away from float32, by more at fp8."""
    P = program.make_weights(DIT, 11, "cpu", "f32")
    mod = program.reference_module(DIT)
    x, t, text, uncond = _inputs()
    exact = mod.Model(P, DIT)(x, t, text, uncond)
    from benchmark.reference.precision import Precision

    rounded = mod.Model(P, DIT, Precision(precision))(x, t, text, uncond)
    rel = float((rounded - exact).norm() / exact.norm())
    assert (1e-4 < rel < 2e-2) if precision == "bf16" else (2e-2 < rel < 0.5)


@pytest.mark.parametrize("B,frames", [(1, 1), (64, 196)])
def test_dit_flops_are_the_hand_count(B, frames):
    """forward_flops against a count written out layer by layer: two timestep
    Denses and the text Dense on B rows, input and output projections on B·T
    rows, the final adaLN Dense, and per block the adaLN Dense on B rows, qkv,
    out, fc1 and fc2 on B·T rows and attention's 4·B·T²·D; at DiT-XL's widths
    (B=64 under CFG, 196 frames) 11.549 TFLOP."""
    cfg = dict(njoints=263, latent_dim=48, ff_size=96, layers=2, heads=4, clip_dim=512,
               reference="dit")
    D, FF, F, C, L, T = 48, 96, 263, 512, 2, frames
    rows = B * T
    hand = 2 * B * (2 * D * D + C * D + 2 * D * D) + 2 * rows * (F * D + D * F)
    hand += L * (2 * B * D * 6 * D + 2 * rows * (3 * D * D + D * D + D * FF + FF * D)
                 + 4 * B * T * T * D)
    assert models.forward(cfg, B, frames) == hand
    xl = dict(cfg, latent_dim=1152, ff_size=4608, layers=28, heads=16)
    assert 11.548e12 < models.forward(xl, 64, 196) < 11.550e12


@pytest.mark.parametrize("cell", list(CELLS))
def test_offline_ext_driver_runs_a_tiny_cell_correctly(tmp_path, cell):
    result = bench_run.execute(ext_bench(), cell, 2**31 + 7, 1.0, False, "cpu",
                               root=ext_tree(tmp_path), t_start=time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"samples_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_keyframes_reach_the_program_and_the_reference(tmp_path):
    """The keyframed cell's batches carry lo..hi observed frames a request, drawn
    from the seed; a sample with its keyframes dropped on the way to the program
    is not correct."""
    root = ext_tree(tmp_path)
    cell = spec.load_cell(ext_bench(), "tiny.offline_kf", root)
    run = bench_run.Run(cell, 5, 0.5, False, torch.device("cpu"))
    s = spec.driver("offline_batch_ext", root).Session(run)
    obs_x0, obs_mask = s._keyframes(0)
    frames = obs_mask.any(axis=2).sum(axis=1)
    assert obs_x0.shape == (3, 12, 263) and set(frames) <= {2, 3, 4, 5}
    assert (obs_mask.all(axis=2) == obs_mask.any(axis=2)).all()  # every feature of a frame
    again, _ = s._keyframes(0)
    assert (again == obs_x0).all() and not (s._keyframes(1)[0] == obs_x0).all()
    s.setup()
    blank = {"obs_x0": torch.zeros(3, 12, 263), "obs_mask": torch.zeros(3, 12, 263, dtype=bool)}
    s._obs = lambda k: blank  # the window's batches without their keyframes
    s.window()
    s.release()
    assert not s.check()[0][1] <= cell.traffic["check"]["limit"]


def test_census_finds_the_dit_attention():
    from benchmark.core import serving

    drv = spec.driver("offline_batch_ext")
    model, *_ = program.build(DIT, 3, "cpu", "f32")
    calls = drv.attention_census(model, serving.census_forward(model, DIT, 6, "cpu", False))
    (attn,) = [c for c in calls if c.kernel == "attention"]
    assert attn.key == (6, 12, 48, 4, "f32", False) and attn.count == 2


def test_the_slice_covers_the_steps_named():
    """The slice opens before the last n // 2 steps of the first batch that is
    ready and closes after the first n - n // 2 of the next (n = steps // 10, at
    least 2), then gives the program its graphs back; a slice still open when
    the window ends closes with it."""
    drv = spec.driver("offline_batch_ext")
    seen = []

    class Slice:
        running, t1 = False, None

        def start(self):
            self.running = True
            seen.append("start")

        def stop(self):
            self.running, self.t1 = False, 0.0
            seen.append("stop")

    class Program:
        graphs = {None: lambda check=True: seen.append("step")}

    def batches(cut, k, steps, ready_from):
        for b in range(k):
            cut.batch()
            for _ in range(steps):
                ready[0] = b >= ready_from
                prog.graphs[None](check=False)
            seen.append("end")

    prog, held, ready = Program(), dict(Program.graphs), [False]
    with drv.BoundarySlice(prog, 40, Slice(), lambda: ready[0]) as cut:
        batches(cut, 3, 40, 1)
    assert cut.n == 4 and prog.graphs == held
    assert seen == (["step"] * 40 + ["end"] + ["step"] * 38 + ["start"] + ["step"] * 2 + ["end"]
                    + ["step"] * 2 + ["stop"] + ["step"] * 38 + ["end"])
    seen.clear()
    with drv.BoundarySlice(prog, 5, Slice(), lambda: ready[0]) as cut:
        batches(cut, 1, 5, 0)
    assert cut.n == 2 and seen == ["step"] * 4 + ["start", "step", "end", "stop"]


def test_pack_share_reads_the_route_counts():
    read = spec.reader("attention.pack_share.offline").read
    assert read({}) is None
    assert read({"attention_routes": {"wgmma": 0, "stream_packed": 0}}) is None
    routes = {"wgmma": 0, "wgmma_f32": 0, "stream": 1, "stream_packed": 3}
    assert read({"attention_routes": routes}) == 75.0
    assert spec.reader("resblock_roofline.offline").read({}) is None
