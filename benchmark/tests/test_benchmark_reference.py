"""The plain references against the port at tiny sizes on the CPU, layer by
layer as a cell covers them, and the frozen counts against the bounds PERF.md
recorded on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_tiny import MDM, UNET, execute, tree

from benchmark.core import program, sampled
from benchmark.counts import attention, models, resblock


def _inputs(B=3, T=12, F=263):
    g = torch.Generator().manual_seed(0)
    return dict(x=torch.randn((B, T, F), generator=g), t=torch.tensor([3, 500, 999]),
                text=torch.randn((B, 512), generator=g),
                uncond=torch.tensor([False, True, False]),
                obs=torch.randn((B, T, F), generator=g),
                mask=torch.rand((B, T, F), generator=g) < 0.3)


@pytest.mark.parametrize("cfg", [UNET, MDM], ids=["unet", "mdm"])
def test_forward_matches_the_port(cfg):
    model, *_ = program.build(cfg, 11, "cpu", "f32")
    ref = program.reference_module(cfg).Model(program.make_weights(cfg, 11, "cpu", "f32"), cfg)
    i = _inputs()
    y = {"text_embed": i["text"], "uncond": i["uncond"]}
    with torch.no_grad():
        if cfg["reference"] == "unet":
            got = model(i["x"], i["t"], y, obs_x0=i["obs"], obs_mask=i["mask"])
        else:
            got = model(i["x"], i["t"], y)
    want = ref(i["x"], i["t"], i["text"], i["uncond"], i["obs"], i["mask"])
    assert (got - want).abs().max() <= 1e-5 * (1 + want.abs().max())


def test_bf16_input_rounds_as_the_port():
    """Training under use_fp16: the port's UNet takes x, the keyframes and the text
    in bfloat16, and its first block computes from them as the reference's
    `bf16_input` says: the first half from bfloat16-rounded operands (to float32
    rounding, and not without the rounding), the residual conv in bfloat16."""
    from benchmark.reference import unet as ref_unet

    model, *_ = program.build(UNET, 11, "cpu", "f32")
    P = program.make_weights(UNET, 11, "cpu", "f32")
    seen = {}
    for name in ("unet.down0_res1", "unet.down0_res1.block1",
                 "unet.down0_res1.residual_conv"):
        model.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: seen.__setitem__(name, (i, o)))
    i = _inputs()
    y = {"text_embed": i["text"], "uncond": i["uncond"]}
    with torch.no_grad():
        got = model(i["x"].bfloat16(), i["t"], y, obs_x0=i["obs"].bfloat16(),
                    obs_mask=i["mask"]).float()
        ref = program.reference_module(UNET).Model(P, UNET, bf16_input=True)
        want = ref(i["x"], i["t"], i["text"], i["uncond"], i["obs"], i["mask"])
        (x, c), _ = seen["unet.down0_res1"]
        assert x.dtype == torch.bfloat16
        cond = torch.nn.functional.linear(c, P["unet.down0_res1.time_mlp.weight"],
                                          P["unet.down0_res1.time_mlp.bias"])
        scale, shift = cond.chunk(2, dim=-1)
        half = seen["unet.down0_res1.block1"][1]
        for q, close in ((ref_unet._bf16, True), (ref_unet._same, False)):
            h = ref_unet._half(P, "unet.down0_res1.block1", x.float(), ref_unet.EXACT, scale,
                               shift, q=q)
            assert (((half - h).abs().max() / h.abs().max()) < 1e-6) == close
        res = ref_unet._conv1x1_bf16(x.float(), P["unet.down0_res1.residual_conv.weight"],
                                     P["unet.down0_res1.residual_conv.bias"])
        port_res = seen["unet.down0_res1.residual_conv"][1]
        assert port_res.dtype == torch.bfloat16
        # within a bfloat16 unit at the output's scale: the sums' order and the bias's
        # rounding put a few outputs a unit apart
        assert (port_res.float() - res).abs().max() <= 2.0 ** -7 * res.abs().max()
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()


def test_served_motions_match_the_reference_sampler():
    """MotionServer's batch (CFG, the DDPM posterior step, keyframes in the input)
    against the reference sampler following the batch's noise stream."""
    from condmdi_tpu_torch.serving import MotionRequest, MotionServer

    cfg = UNET
    model, sched, dcfg, _ = program.build(cfg, 11, "cpu", "f32")
    from benchmark.core.serving import pipeline

    server = MotionServer(pipeline(model, sched, dcfg, "cpu", True), 12, 263, max_batch=4,
                          max_wait_ms=300, guidance_param=2.5)
    rng = np.random.default_rng(0)
    reqs = [MotionRequest(text_embed=rng.standard_normal(512).astype(np.float32),
                          obs_x0=rng.standard_normal((12, 263)).astype(np.float32),
                          obs_mask=rng.random((12, 263)) < 0.2, seed=77 + i) for i in range(3)]
    try:
        for r in reqs:
            server.submit(r)
        outs = [r.result(timeout=120) for r in reqs]
    finally:
        server.shutdown()
    assert server.batches == [(3, 4)]
    placed = [sampled.Placed(77, 4, i, torch.from_numpy(r.text_embed), torch.from_numpy(r.obs_x0),
                             torch.from_numpy(r.obs_mask)) for i, r in enumerate(reqs)]
    want = sampled.reference_motions(cfg, 11, "f32", placed, 2.5, "cpu")
    assert float(sampled.rel_rms(torch.from_numpy(np.stack(outs)), want).max()) < 1e-4


def test_train_steps_match_the_reference(tmp_path):
    """Three train steps of the port (the loss, the gradients through the kernels'
    autograd Functions' plain CPU versions, the clip, AdamW) against the reference's
    from the same batches and draws, in float32: the run's three numbers at rounding."""
    result = execute(tree(tmp_path), "tiny.train")
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["loss_rel_gap_max"] < 1e-6
    assert checks["first_grad_leaf_gap_max"] < 1e-4
    assert checks["param_change_leaf_gap_max"] < 1e-4


def test_counts_pin_the_recorded_bounds():
    """PERF.md §6's bounds: the resblock halves of UNet-XL at pad 200, B=8 bf16
    0.236 ms; pad 224, B=4 f32 0.3190 ms; training, B=64 f32 3.914 ms; MDM's 8
    self-attentions at B=8, T=197 bf16 0.0154 ms."""
    xl = dict(njoints=263, latent_dim=512, dim_mults=[2, 2, 2, 2], clip_dim=512, reference="unet")

    def halves(pad, B, dtype):
        return sum(resblock.bound_ms(B, T, ci, co, a, r, dtype)
                   for T, ci, co, a, r in models.unet_halves(dict(xl, pad=pad), B))

    assert len(models.unet_halves(dict(xl, pad=224), 1)) == 33
    assert round(halves(200, 8, "bf16"), 3) == 0.236
    assert round(halves(224, 4, "f32"), 4) == 0.3190
    assert round(halves(224, 64, "f32"), 3) == 3.914
    assert round(8 * attention.bound_ms(8, 197, 512, 4, "bf16"), 4) == 0.0154
    mdm = dict(njoints=263, latent_dim=512, ff_size=1024, layers=8, heads=4, clip_dim=512,
               reference="mdm")
    assert 460e9 < models.forward(mdm, 64, 196) < 475e9
