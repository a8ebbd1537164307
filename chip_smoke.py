"""Drive condmdi_tpu_torch on one NVIDIA GPU and hold its kernel to its plain version.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. setup: card name and power limit, torch/CUDA versions, kernel build time;
  2. the fused resblock kernel against its plain PyTorch version at every
     distinct resblock shape of a UNet-XL forward (B=8, pad 200), in bf16 and
     float32, with times (CUDA events, median of repeats, inputs rotated
     through more than the 50 MB L2 so weights arrive cold, as in a forward);
  3. the whole path, kernel against plain: a 20-step DDIM (eta 0) at UNet-XL
     in float32, B=2, run once through the kernel and once with the resblock
     halves swapped for the plain version;
  4. serving: MotionServer over SamplePipeline with UNet-XL in bf16, the
     1000-step cosine DDPM, CFG 2.5 and 4 concurrent keyframe requests; the
     kernel's launch count must equal 33 × steps × batches;
  5. a {"kernels": [...]} line, the card line, and the final {"ok": true, ...}.

Per-shape results also go to chiprun_out/chip_smoke.json. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
T_FRAMES, FEATS, PAD = 196, 263, 200
XL = dict(njoints=FEATS, latent_dim=512, dim_mults=(2, 2, 2, 2),
          keyframe_conditioned=True, pad_frames_to=PAD)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
BF16_TOL = 2.0 ** -7      # |kernel - plain| <= tol * (1 + |plain|): ~2 bf16 ulps
F32_TOL = 5e-4            # hi+lo bf16 split keeps ~16 mantissa bits
DDIM_TOL = 5e-3           # max |kernel path - plain path| after 20 f32 DDIM steps
SERVE_REQUESTS, SERVE_STEPS, GUIDANCE = 4, 1000, 2.5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def timed_ms(fn, inputs, reps=5, iters=10) -> float:
    """Median over `reps` of the mean time of `iters` calls, cycling `inputs`."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


# --------------------------------------------------------------------------- #
# phase 2: kernel against plain at every resblock shape of the main path
# --------------------------------------------------------------------------- #
def record_resblock_shapes(model, x, t, y, kw):
    """(Cin, Cout, T, adagn, res) -> count, from one forward's resblock halves."""
    from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock, Conv1dBlock

    counts: dict[tuple, int] = {}

    def hook(mod, args, kwargs, _out):
        xin = args[0]
        ada = isinstance(mod, Conv1dAdaGNBlock)
        res = kwargs.get("res", args[1] if len(args) > 1 and not ada else None) is not None
        key = (xin.shape[-1], mod.conv.weight.shape[0], xin.shape[1], ada, res)
        counts[key] = counts.get(key, 0) + 1

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, (Conv1dBlock, Conv1dAdaGNBlock))]
    with torch.no_grad():
        model(x, t, y, **kw)
    for h in handles:
        h.remove()
    return counts


def make_case(B, T, cin, cout, ada, res, dtype, gen, dev):
    def rnd(shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to(dev, dtype)

    args = [rnd((B, T, cin)), rnd((cout, cin, 5), (1.0 / (cin * 5)) ** 0.5),
            rnd((cout,), 0.1), 1 + rnd((cout,), 0.1), rnd((cout,), 0.1)]
    kw = {}
    if ada:
        cond = rnd((B, 2 * cout), 0.2)  # scale/shift are views of one [B, 2C] row
        kw["scale"], kw["shift"] = cond[:, :cout], cond[:, cout:]
    if res:
        kw["res"] = rnd((B, T, cout))
    return args, kw


def bound_ms(B, T, cin, cout, ada, res, k=5, itemsize=2) -> tuple[float, str]:
    flops = 2.0 * B * T * cin * cout * k
    elems = B * T * cin + k * cin * cout + 3 * cout + B * T * cout
    elems += (2 * B * cout if ada else 0) + (B * T * cout if res else 0)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, elems * itemsize / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def library_composite(x_bct, w, b, gamma, beta, scale=None, shift=None, res_bct=None):
    """cuDNN conv + group_norm + AdaGN + mish (+res), [B, C, T]: the yardstick only."""
    h = F.group_norm(F.conv1d(x_bct, w, b, padding=2), 8, gamma, beta)
    if scale is not None:
        h = h * (1 + scale[:, :, None]) + shift[:, :, None]
    h = F.mish(h)
    return h if res_bct is None else h + res_bct


def check_kernel(shapes, dev, batch=8):
    from condmdi_tpu_torch.ops.resblock import fused_conv_gn_mish, reference_conv_gn_mish

    gen = torch.Generator().manual_seed(1)
    rows = []
    for (cin, cout, T, ada, res), count in sorted(shapes.items()):
        row = dict(cin=cin, cout=cout, T=T, B=batch, adagn=ada, res=res, per_forward=count)
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            args, kw = make_case(batch, T, cin, cout, ada, res, dtype, gen, dev)
            with torch.no_grad():
                got = fused_conv_gn_mish(*args, **kw, n_groups=8)
                torch.cuda.synchronize()
                want = reference_conv_gn_mish(*args, **kw, n_groups=8)
            err = (got.float() - want.float()).abs()
            bad = (err > tol * (1 + want.float().abs())).sum().item()
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            row[f"max_abs_err_{name}"] = err.max().item()
            print(f"[kernel] {name} Cin={cin} Cout={cout} T={T} B={batch} adagn={ada} res={res}: "
                  f"max_abs_err={err.max().item():.3e} (tol {tol:.1e}*(1+|plain|)), "
                  f"{bad} outside", flush=True)
            if bad or not torch.isfinite(got).all():
                raise SystemExit(f"kernel disagrees with its plain version at {row}")
        # times in bf16, the serving type; enough input sets to exceed L2
        one = 2 * (batch * T * cin + cout * cin * 5)  # bytes of x and w in bf16
        n_sets = max(2, -(-64 * 2**20 // one))
        cases = [make_case(batch, T, cin, cout, ada, res, torch.bfloat16, gen, dev)
                 for _ in range(n_sets)]
        with torch.no_grad():
            kin = [(*a, kw.get("scale"), kw.get("shift"), kw.get("res")) for a, kw in cases]
            row["ms"] = timed_ms(lambda *z: fused_conv_gn_mish(*z), kin)
            row["plain_ms"] = timed_ms(lambda *z: reference_conv_gn_mish(*z), kin)
            lib_in = [(a[0].transpose(1, 2).contiguous(), *a[1:], kw.get("scale"),
                       kw.get("shift"),
                       kw["res"].transpose(1, 2).contiguous() if "res" in kw else None)
                      for a, kw in cases]
            row["library_ms"] = timed_ms(library_composite, lib_in)
        row["bound_ms"], row["bound_by"] = bound_ms(batch, T, cin, cout, ada, res)
        print(f"[kernel] times bf16: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {count} per forward", flush=True)
        rows.append(row)
    return rows


# --------------------------------------------------------------------------- #
# phases 3 and 4: the whole path
# --------------------------------------------------------------------------- #
def build_xl(dev, dtype):
    """UNet-XL with seeded weights, every weight then perturbed (the zero-init
    output layers would otherwise denoise to exactly 0)."""
    from condmdi_tpu_torch.models.unet import MDM_UNET

    model = MDM_UNET(**XL, device=dev, seed=0)
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            p.add_((0.02 * torch.randn(p.shape, generator=gen)).to(dev))
    return model.to(dtype).requires_grad_(False).eval()


def keyframe_inputs(B, seed):
    rng = np.random.default_rng(seed)
    text = torch.from_numpy(rng.standard_normal((B, 512)).astype(np.float32))
    obs = torch.from_numpy(rng.standard_normal((B, T_FRAMES, FEATS)).astype(np.float32) * 0.1)
    mask = torch.zeros((B, T_FRAMES, FEATS), dtype=torch.bool)
    mask[:, ::10] = True
    return text, obs, mask


def ddim_kernel_vs_plain(dev):
    import condmdi_tpu_torch.models.unet as unet_mod
    from condmdi_tpu_torch.diffusion import (
        DiffusionConfig, DiffusionSchedule, SamplerConfig, get_named_beta_schedule,
    )
    from condmdi_tpu_torch.ops.resblock import reference_conv_gn_mish
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    B = 2
    model = build_xl(dev, torch.float32)
    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 1000),
                                     use_timesteps=range(0, 1000, 50))
    pipe = SamplePipeline(model, sched, DiffusionConfig(), SamplerConfig(method="ddim"),
                          device=dev)
    text, obs, mask = keyframe_inputs(B, 0)
    noise = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, T_FRAMES, FEATS)).astype(np.float32)).to(dev)

    def run():
        out = pipe.sample((B, T_FRAMES, FEATS), {"text_embed": text.to(dev)},
                          obs_x0=obs.to(dev), obs_mask=mask.to(dev), noise=noise)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    got = run()
    t_kernel = time.perf_counter() - t0
    kernel_fn = unet_mod.fused_conv_gn_mish
    unet_mod.fused_conv_gn_mish = reference_conv_gn_mish  # the plain path, this run only
    try:
        t0 = time.perf_counter()
        want = run()
        t_plain = time.perf_counter() - t0
    finally:
        unet_mod.fused_conv_gn_mish = kernel_fn
    err = (got - want).abs().max().item()
    print(f"[ddim] UNet-XL f32 DDIM-20 B={B}: max|kernel - plain| = {err:.3e} "
          f"(tol {DDIM_TOL:.0e}), max|plain| = {want.abs().max().item():.3f}, "
          f"kernel path {t_kernel:.2f} s, plain path {t_plain:.2f} s", flush=True)
    if not (torch.isfinite(got).all() and err <= DDIM_TOL and want.abs().max() > 0):
        raise SystemExit("the kernel path disagrees with the plain path over DDIM-20")
    return err


def serve(dev, card):
    from condmdi_tpu_torch.diffusion import (
        DiffusionConfig, DiffusionSchedule, SamplerConfig, get_named_beta_schedule,
    )
    from condmdi_tpu_torch.ops.resblock import fused_conv_gn_mish
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline
    from condmdi_tpu_torch.serving import MotionRequest, MotionServer

    model = build_xl(dev, torch.bfloat16)

    def apply_fn(x, t, y, **kw):  # bf16 model, sampler math in float32
        return model(x.to(torch.bfloat16), t, y, **kw).float()

    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", SERVE_STEPS))
    pipe = SamplePipeline(apply_fn, sched, DiffusionConfig(), SamplerConfig(), device=dev)
    server = MotionServer(pipe, T_FRAMES, FEATS, max_batch=SERVE_REQUESTS, max_wait_ms=500,
                          guidance_param=GUIDANCE)
    try:
        server.warmup(buckets=(SERVE_REQUESTS,))
        text, obs, mask = keyframe_inputs(SERVE_REQUESTS, 1)
        fused_conv_gn_mish.launches = 0
        t0 = time.perf_counter()
        reqs = [server.submit(MotionRequest(text_embed=text[i].numpy(), obs_x0=obs[i].numpy(),
                                            obs_mask=mask[i].numpy(), seed=i))
                for i in range(SERVE_REQUESTS)]
        outs = [r.result(timeout=900) for r in reqs]
        wall = time.perf_counter() - t0
        launches = fused_conv_gn_mish.launches
    finally:
        server.shutdown()
    if server._thread.is_alive():
        raise SystemExit("the server thread did not stop")
    n_batches = len(server.batches)
    expected = 33 * SERVE_STEPS * n_batches
    ok_shapes = all(o.shape == (T_FRAMES, FEATS) and np.isfinite(o).all() for o in outs)
    spread = float(np.std(np.stack(outs)))
    print(f"[serve] {card}: UNet-XL bf16, {SERVE_STEPS}-step DDPM, CFG {GUIDANCE}, "
          f"{SERVE_REQUESTS} keyframe requests in batches {server.batches}: wall {wall:.3f} s, "
          f"{SERVE_REQUESTS / wall:.4f} samples/s; resblock launches {launches} "
          f"(expected 33 x {SERVE_STEPS} x {n_batches} = {expected})", flush=True)
    if not ok_shapes or spread == 0.0:
        raise SystemExit("served motions are not finite [196, 263] arrays")
    if server.batches != [(SERVE_REQUESTS, SERVE_REQUESTS)]:
        raise SystemExit(f"requests were not coalesced into one bucket: {server.batches}")
    if launches != expected:
        raise SystemExit(f"resblock launches {launches} != {expected}")
    return dict(wall_s=wall, samples_per_s=SERVE_REQUESTS / wall, steps=SERVE_STEPS,
                batches=server.batches, launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from condmdi_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"[setup] {card}; python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_resblock()
    print(f"[setup] resblock kernel ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds.get('resblock.cu', 0.0):.2f} s)", flush=True)
    for line in _build.build_log.get("resblock.cu", "").splitlines():
        if "registers" in line or "spill" in line:  # ptxas -v, one pair per instantiation
            print(f"[setup] ptxas: {line.strip()}", flush=True)

    # the main path's resblock shapes, from one bf16 UNet-XL forward at B=8
    model = build_xl(dev, torch.bfloat16)
    text, obs, mask = keyframe_inputs(8, 2)
    shapes = record_resblock_shapes(
        model, torch.randn(8, T_FRAMES, FEATS, device=dev, dtype=torch.bfloat16),
        torch.full((8,), 500, device=dev), {"text_embed": text.to(dev)},
        dict(obs_x0=obs.to(dev), obs_mask=mask.to(dev)))
    del model
    if sum(shapes.values()) != 33:
        raise SystemExit(f"expected 33 resblock halves per forward, found {shapes}")
    rows = check_kernel(shapes, dev)
    ddim_err = ddim_kernel_vs_plain(dev)
    served = serve(dev, card)

    def per_forward(key):
        return sum(r[key] * r["per_forward"] for r in rows)

    ops_bound = sum(r["bound_ms"] * r["per_forward"] for r in rows
                    if r["bound_by"] == "operations")
    kernels = [{
        "name": "fused_conv_gn_mish",
        "route": "cuda",
        "source": "condmdi_tpu_torch/csrc/resblock.cu",
        "replaces": "condmdi_tpu/ops/resblock.py:53",
        "launches": served["launches"],
        "max_abs_err": max(r["max_abs_err_bf16"] for r in rows),
        "max_abs_err_f32": max(r["max_abs_err_f32"] for r in rows),
        "ddim_max_abs_err_f32": ddim_err,
        # times: the 33 resblock halves of one UNet-XL forward at B=8, bf16
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": "operations" if ops_bound >= per_forward("bound_ms") / 2 else "bytes",
        "library_ms": per_forward("library_ms"),
    }]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "shapes": rows, "serve": served, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
