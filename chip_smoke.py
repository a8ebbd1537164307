"""Drive condmdi_tpu_torch on one NVIDIA GPU and hold its kernels to their plain versions.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. setup: card name and power limit, torch/CUDA versions, the three sources
     built at once (one nvcc each), their ptxas register/spill lines;
  2. the fused resblock kernel against its plain PyTorch version at every
     distinct resblock shape of a UNet-XL forward (pad 200), as the forward
     hands it over (the first block's x has 528 channels for a 526-channel
     weight), in bf16 at B = 8, 1 and 3 and in float32 at B = 8; each AdaGN
     shape again through a Conv1dAdaGNBlock
     (its cached packed weight), before and after the weight changes in
     place; then times at B=8 (CUDA events, median of repeats, inputs rotated
     through more than the 50 MB L2 so weights arrive cold, as in a forward;
     the kernel is called with a packed weight made beforehand, as the
     modules call it) with the wrapper's host enqueue time, and two shapes
     at B=64 for information;
  3. the UNet-XL path, kernel against plain: a 20-step DDIM (eta 0) in
     float32, B=2, run once through the kernel and once with the resblock
     halves swapped for the plain version;
  4. UNet-XL serving: MotionServer over SamplePipeline in bf16, the 1000-step
     cosine DDPM, CFG 2.5 and 4 concurrent keyframe requests; the resblock
     kernel's launch count must equal 33 x steps x batches; one bf16 forward
     at B=8, kernel path against plain path; that forward on the host clock
     against its device time, and its device time by kernel (torch.profiler);
  5. the fused self-attention kernels against their plain version in bf16 and
     float32 at the MDM served shape, the bench batch, DiT / trans_dec and a
     ragged shape, with the route each took (bf16: the resident wgmma kernel;
     float32: the tiled mma.sync one) and times as in phase 2 beside one
     scaled_dot_product_attention call (q, k, v are the column views of one
     [B, T, 3D] projection, as on the path); then one `mha` call captured in a
     CUDA graph on a side stream and replayed twice on new contents, which
     must equal the eager call bit for bit;
  6. the MDM path, kernel against plain: the full-width bench MDM (trans_enc,
     8 layers, latent 512) over a float32 DDIM-20, B=2;
  7. MDM keyframe editing under autograd, kernel against plain: no_cond MDM,
     imputation + reconstruction guidance over a 50-step respaced DDPM, f32;
  8. MDM serving: MotionServer in bf16, 1000-step DDPM, CFG 2.5, 4 concurrent
     text requests (HashTextEncoder embeddings); attention launches must equal
     8 x steps x batches; one bf16 forward at B=8, kernel path against plain
     path; that forward on the host clock against its device time, which says
     whether a step is launch-bound, and its device time by kernel;
  9. one full-width MDM_DiT (dit_prenorm) forward, kernel against plain, with
     its 8 launches; for information, one bf16 MDM forward at the evaluation
     batch (B=128), device time by kernel and attention's share of it;
 10. the int8 conv kernel against its plain version at every int8 conv shape
     of one UNet-XL int8_static forward at B=8 (the 41 QConv calls, recorded
     by a hook; the first block's x has 528 channels for a 526-channel
     weight), each in the three activation-scale forms (dynamic per tensor,
     static per tensor, per input channel folded into the weight) and in
     bf16 and f32; then bf16 times in the served form (static per tensor):
     kernel, plain, the library composite (amax + quantize + im2col +
     torch._int_mm + dequant), bound, host enqueue, and for information the
     bf16 cuDNN conv the float twin pays; the same for MDM's four int8 QDense
     shapes at B=8 and B=128 (dynamic);
 11. the int8 paths, kernel against plain: UNet-XL int8_static over a float32
     DDIM-20 at B=2 (820 launches); one bf16 int8_static UNet-XL forward and
     one bf16 int8 MDM forward at B=8; then the port's
     bench.verify_trajectory("unet_int8_static") against the committed golden
     tests/golden/bench_traj_unet_pad200.json (mean-relative <= 0.10), beside
     the float family's max-abs result (printed, for information);
 12. mixed-step serving: the bf16 int8_static UNet-XL calibrated along one
     CFG 2.5, 1000-step DDPM trajectory at the served shape
     (calibrate_act_scales_trajectory), then phase 4's 4 keyframe requests
     through MotionServer with MixedStepDenoiser at k_float = 250: exactly
     41 x 750 int8 and 33 x 250 resblock launches; samples/s beside phase 4's;
     one int8 forward's host time, device time and kernels by time;
 13. a {"kernels": [...]} line (three kernels), the card line, and the final
     {"ok": true, ...}.

Per-shape results also go to chiprun_out/chip_smoke.json. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
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
DDIM_TOL = 5e-3           # max |kernel path - plain path| over a whole f32 sampler run
# One bf16 forward, kernel path against plain path. Each layer's output is
# rounded to bf16 on both paths, an ulp (2^-8 relative) apart at most per layer,
# and the differences add up like a random walk over the 33 resblock halves of
# the UNet or the 8 transformer layers of MDM. The check holds the relative rms
# of the difference, rms(kernel - plain) / rms(plain), to twice what these two
# forwards gave on an NVIDIA H100 80GB HBM3 (1.0e-2 and 0.8e-2, PERF.md
# section 6); a kernel a few times worse than that fails. No single element may
# lie further out than BF16_FORWARD_OUTLIER * (1 + |plain|): that catches a
# wrong tile, which an rms over the whole output would hide.
BF16_FORWARD_REL_RMS = 2e-2
BF16_FORWARD_OUTLIER = 2.0 ** -4
# What the first versions of the two kernels took, for the "before" lines only
# (PERF.md section 6, re-measured with this script's method; NVIDIA H100 80GB
# HBM3, 700 W). Not measured by this run, so not part of the kernels line.
PREV_RESBLOCK_MS = 17.34   # the 33 halves of one UNet-XL forward at B=8, bf16
PREV_ATTENTION_MS = 0.368  # the 8 self-attentions of one MDM forward at B=8, bf16
PREV_ATTENTION_BENCH_BATCH_MS = 0.290  # one self-attention at B=128, same kernel and card
SERVE_REQUESTS, SERVE_STEPS, GUIDANCE = 4, 1000, 2.5
MDM = dict(njoints=FEATS, latent_dim=512, ff_size=1024, num_layers=8, num_heads=4)  # bench.py mdm
MDM_TOKENS = T_FRAMES + 1  # the frames and the conditioning token
ATTN_SHAPES = [  # (name, B, T, D, H)
    ("mdm_served", 8, MDM_TOKENS, 512, 4),     # 4 requests x CFG
    ("mdm_bench_batch", 128, MDM_TOKENS, 512, 4),
    ("dit_trans_dec", 8, T_FRAMES, 512, 4),    # no conditioning token in the sequence
    ("ragged", 3, 25, 128, 2),                 # hd 64, one ragged key tile
]
# the int8 kernel against its plain version: float32 within INT8_F32_TOL * (1 + |plain|)
# (the integer sums are exact on both sides, the epilogue is the same two float32
# roundings), bfloat16 within one output ulp (INT8_BF16_ULP * |plain|)
INT8_F32_TOL = 1e-6
INT8_BF16_ULP = 2.0 ** -7
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
MDM_QDENSE = [(512, 1536), (512, 512), (512, 1024), (1024, 512)]  # qkv, attn_out, ff1, ff2
K_FLOAT = 250  # the mixed-step sampler's float tail (bench.py BENCH_FLOAT_LAST_K)
PROMPTS = ["a person walks forward", "a person jumps in place", "someone waves with the left hand",
           "a person sits down slowly"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def timed_ms(fn, inputs, reps=5, iters=10) -> tuple[float, float]:
    """(device ms, host ms) per call. Device: median over `reps` of the mean time
    of `iters` calls, cycling `inputs`; each repeat starts behind a spin kernel
    longer than the host takes to enqueue the calls, so host overhead between
    launches is not counted. Host: the time to enqueue one call."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(4e9 * host_s) + 2_000_000  # twice the host time at up to 2 GHz
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        e0.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times), host_s * 1e3 / iters


# --------------------------------------------------------------------------- #
# phase 2: kernel against plain at every resblock shape of the main path
# --------------------------------------------------------------------------- #
def record_resblock_shapes(model, x, t, y, kw):
    """(Cin, Cout, T, adagn, res, x channels) -> count, from one forward's resblock
    halves: the weight's Cin and the channel count of the x the wrapper was given
    (the UNet pads its first block's 526 channels to 528)."""
    from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock, Conv1dBlock

    counts: dict[tuple, int] = {}

    def hook(mod, args, kwargs, _out):
        xin = args[0]
        ada = isinstance(mod, Conv1dAdaGNBlock)
        res = kwargs.get("res", args[1] if len(args) > 1 and not ada else None) is not None
        key = (mod.conv.weight.shape[1], mod.conv.weight.shape[0], xin.shape[1], ada, res,
               xin.shape[2])
        counts[key] = counts.get(key, 0) + 1

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, (Conv1dBlock, Conv1dAdaGNBlock))]
    with torch.no_grad():
        model(x, t, y, **kw)
    for h in handles:
        h.remove()
    return counts


def make_case(B, T, cin, cout, ada, res, dtype, gen, dev, xc=None):
    """One call's tensors; x has `xc` >= cin channels, those past cin zero, as the
    UNet's padded input has them."""
    def rnd(shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to(dev, dtype)

    args = [F.pad(rnd((B, T, cin)), (0, (xc or cin) - cin)),
            rnd((cout, cin, 5), (1.0 / (cin * 5)) ** 0.5),
            rnd((cout,), 0.1), 1 + rnd((cout,), 0.1), rnd((cout,), 0.1)]
    kw = {}
    if ada:
        cond = rnd((B, 2 * cout), 0.2)  # scale/shift are views of one [B, 2C] row
        kw["scale"], kw["shift"] = cond[:, :cout], cond[:, cout:]
    if res:
        kw["res"] = rnd((B, T, cout))
    return args, kw


def bound_ms(B, T, cin, cout, ada, res, k=5, itemsize=2) -> tuple[float, str]:
    """The conv's operations and the function's bytes (alignment channels are
    no part of the function and are not counted)."""
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


def kernel_against_plain(B, T, cin, cout, ada, res, xc, dtype, tol, gen, dev):
    """max |kernel - plain| of one call, or exit."""
    from condmdi_tpu_torch.ops.resblock import fused_conv_gn_mish, reference_conv_gn_mish

    args, kw = make_case(B, T, cin, cout, ada, res, dtype, gen, dev, xc)
    with torch.no_grad():
        got = fused_conv_gn_mish(*args, **kw, n_groups=8)
        torch.cuda.synchronize()
        want = reference_conv_gn_mish(*args, **kw, n_groups=8)
    err = (got.float() - want.float()).abs()
    bad = (err > tol * (1 + want.float().abs())).sum().item()
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    print(f"[kernel] {name} x[{B},{T},{xc}] Cin={cin} Cout={cout} adagn={ada} res={res}: "
          f"max_abs_err={err.max().item():.3e} (tol {tol:.1e}*(1+|plain|)), "
          f"{bad} outside", flush=True)
    if bad or not torch.isfinite(got).all():
        raise SystemExit(f"kernel disagrees with its plain version at B={B} T={T} Cin={cin} "
                         f"adagn={ada} res={res} {name}")
    return err.max().item()


def module_follows_its_weight(T, cin, cout, xc, gen, dev, batch=8):
    """A Conv1dAdaGNBlock (cached packed weight) against plain, before and after
    its weight changes in place: the stale-cache check."""
    from condmdi_tpu_torch.models.unet import Conv1dAdaGNBlock
    from condmdi_tpu_torch.ops.resblock import reference_conv_gn_mish

    args, kw = make_case(batch, T, cin, cout, True, False, torch.bfloat16, gen, dev, xc)
    block = Conv1dAdaGNBlock(cin, cout, device=dev, dtype=torch.bfloat16).requires_grad_(False)
    for p, v in zip((block.conv.weight, block.conv.bias, block.norm.weight, block.norm.bias),
                    args[1:]):
        p.copy_(v)
    outs = []
    for step in ("first", "after an in-place weight change"):
        with torch.no_grad():
            got = block(args[0], kw["scale"], kw["shift"]).float()
            want = reference_conv_gn_mish(args[0], block.conv.weight, block.conv.bias,
                                          block.norm.weight, block.norm.bias, **kw).float()
        bad = ((got - want).abs() > BF16_TOL * (1 + want.abs())).sum().item()
        if bad:
            raise SystemExit(f"module path Cin={cin} T={T}, {step}: {bad} outside the tolerance")
        outs.append(got)
        block.conv.weight.mul_(-1.25)
    moved = (outs[0] - outs[1]).abs().max().item()
    print(f"[kernel] module path Cin={cin} Cout={cout} T={T}: within tolerance before and after "
          f"the weight changed in place; the output moved by {moved:.3f}", flush=True)
    if moved < 0.1:
        raise SystemExit("the module's output did not follow its weight (stale packed copy)")


def time_kernel(B, T, cin, cout, ada, res, xc, gen, dev, library=True):
    """bf16 times of one shape: the kernel through a cached packed weight (as
    the modules call it), its host enqueue, the plain version and the library
    composite; enough input sets to exceed L2."""
    from condmdi_tpu_torch.ops.resblock import (PackedConvWeight, fused_conv_gn_mish,
                                                reference_conv_gn_mish)

    one = 2 * (B * T * cin + cout * cin * 5)  # bytes of x and w in bf16
    n_sets = max(2, -(-64 * 2**20 // one))
    cases = [make_case(B, T, cin, cout, ada, res, torch.bfloat16, gen, dev, xc)
             for _ in range(n_sets)]
    out = {}
    with torch.no_grad():
        kin = [(*a, kw.get("scale"), kw.get("shift"), kw.get("res")) for a, kw in cases]
        caches = {a[1].data_ptr(): PackedConvWeight() for a, _ in cases}
        for a, _ in cases:
            caches[a[1].data_ptr()].get(a[1])
        out["ms"], out["host_ms"] = timed_ms(
            lambda *z: fused_conv_gn_mish(*z, packed=caches[z[1].data_ptr()]), kin)
        if library:
            out["plain_ms"], _ = timed_ms(lambda *z: reference_conv_gn_mish(*z), kin)
            lib_in = [(a[0][..., :cin].transpose(1, 2).contiguous(), *a[1:], kw.get("scale"),
                       kw.get("shift"),
                       kw["res"].transpose(1, 2).contiguous() if "res" in kw else None)
                      for a, kw in cases]
            out["library_ms"], out["library_host_ms"] = timed_ms(library_composite, lib_in)
    return out


def check_kernel(shapes, dev, batch=8):
    gen = torch.Generator().manual_seed(1)
    rows = []
    for (cin, cout, T, ada, res, xc), count in sorted(shapes.items()):
        row = dict(cin=cin, cout=cout, T=T, B=batch, adagn=ada, res=res, x_channels=xc,
                   per_forward=count)
        # bf16, the served type: the grid must not depend on B=8; float32 at B=8
        row["max_abs_err_bf16"] = max(
            kernel_against_plain(B, T, cin, cout, ada, res, xc, torch.bfloat16, BF16_TOL, gen, dev)
            for B in (batch, 1, 3))
        row["max_abs_err_f32"] = kernel_against_plain(
            batch, T, cin, cout, ada, res, xc, torch.float32, F32_TOL, gen, dev)
        if ada:
            module_follows_its_weight(T, cin, cout, xc, gen, dev)
        row.update(time_kernel(batch, T, cin, cout, ada, res, xc, gen, dev))
        row["bound_ms"], row["bound_by"] = bound_ms(batch, T, cin, cout, ada, res)
        print(f"[kernel] times bf16: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {count} per forward; host enqueue per call: kernel wrapper "
              f"{row['host_ms']:.4f} ms, library composite {row['library_host_ms']:.4f} ms",
              flush=True)
        rows.append(row)
    # for information: the evaluation protocol samples at large batch
    big = []
    for T in (200, 25):
        t = time_kernel(64, T, 1024, 1024, True, False, 1024, gen, dev, library=False)
        b, _ = bound_ms(64, T, 1024, 1024, True, False)
        big.append(dict(cin=1024, cout=1024, T=T, B=64, adagn=True, res=False, ms=t["ms"],
                        bound_ms=b))
        print(f"[kernel] for information, B=64 1024->1024 T={T} adagn: kernel {t['ms']:.4f} ms, "
              f"bound {b:.4f} ms", flush=True)
    return rows, big


# --------------------------------------------------------------------------- #
# phases 3 and 4: the UNet-XL path
# --------------------------------------------------------------------------- #
def perturbed(model, dev, dtype):
    """Seeded weights, every weight then perturbed (the zero-init output layers
    would otherwise denoise to exactly 0)."""
    from condmdi_tpu_torch.models.unet import cast_weights

    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            p.add_((0.02 * torch.randn(p.shape, generator=gen)).to(dev))
    # the weights only: an int8 model's calibrated amaxes stay float32
    return cast_weights(model, dtype).requires_grad_(False).eval()


def build_xl(dev, dtype, **kw):
    from condmdi_tpu_torch.models.unet import MDM_UNET

    return perturbed(MDM_UNET(**XL, **kw, device=dev, seed=0), dev, dtype)


def build_mdm(dev, dtype, **kw):
    from condmdi_tpu_torch.models.mdm import MDM as MDMModel

    return perturbed(MDMModel(**MDM, **kw, device=dev, seed=0), dev, dtype)


def keyframe_inputs(B, seed):
    rng = np.random.default_rng(seed)
    text = torch.from_numpy(rng.standard_normal((B, 512)).astype(np.float32))
    obs = torch.from_numpy(rng.standard_normal((B, T_FRAMES, FEATS)).astype(np.float32) * 0.1)
    mask = torch.zeros((B, T_FRAMES, FEATS), dtype=torch.bool)
    mask[:, ::10] = True
    return text, obs, mask


def seeded_noise(shape, dev, seed=7):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dev)


def schedule(steps_kept, total=SERVE_STEPS):
    """The cosine schedule over `total` steps, respaced to `steps_kept` of them."""
    from condmdi_tpu_torch.diffusion import DiffusionSchedule, get_named_beta_schedule

    use = None if steps_kept == total else range(0, total, total // steps_kept)
    return DiffusionSchedule.create(get_named_beta_schedule("cosine", total), use_timesteps=use)


def pipeline(apply_fn, sched, dev, method="ddpm"):
    from condmdi_tpu_torch.diffusion import DiffusionConfig, SamplerConfig
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    return SamplePipeline(apply_fn, sched, DiffusionConfig(), SamplerConfig(method=method),
                          device=dev)


def kernel_vs_plain(tag, label, run, swap):
    """Run the path through the kernel, then with `swap` in place; max |Δ| or exit."""
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    with swap():
        t0 = time.perf_counter()
        want = run()
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    err = (got - want).abs().max().item()
    print(f"[{tag}] {label}: max|kernel - plain| = {err:.3e} (tol {DDIM_TOL:.0e}), "
          f"max|plain| = {want.abs().max().item():.3f}, kernel path {t_kernel:.2f} s, "
          f"plain path {t_plain:.2f} s", flush=True)
    if not (torch.isfinite(got).all() and err <= DDIM_TOL and want.abs().max() > 0):
        raise SystemExit(f"{label}: the kernel path disagrees with the plain path")
    return err


def bf16_forward_kernel_vs_plain(label, call, swap):
    """One bf16 forward through the kernel and one with `swap` in place, held to
    BF16_FORWARD_REL_RMS and BF16_FORWARD_OUTLIER (above); the largest
    difference is printed for information. Returns (max |diff|, relative rms)."""
    with torch.no_grad():
        got = call().float()
        torch.cuda.synchronize()
        with swap():
            want = call().float()
    err = (got - want).abs()
    bad = (err > BF16_FORWARD_OUTLIER * (1 + want.abs())).sum().item()
    rel_rms = (err.pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()
    print(f"[bf16 forward] {label}: relative rms of kernel - plain = {rel_rms:.3e} (limit "
          f"{BF16_FORWARD_REL_RMS:.0e}), {bad} elements beyond {BF16_FORWARD_OUTLIER:.3g}*(1+|plain|); "
          f"for information max|kernel - plain| = {err.max().item():.3e}, max|plain| = "
          f"{want.abs().max().item():.3f}", flush=True)
    if not (rel_rms <= BF16_FORWARD_REL_RMS) or bad or not torch.isfinite(got).all() \
            or want.abs().max() == 0:
        raise SystemExit(f"{label}: the bf16 kernel path disagrees with the plain path")
    return err.max().item(), rel_rms


def forward_host_vs_device(label, call, step_wall_ms):
    """Is a step launch-bound? One forward on the host clock against its device
    time (its launches queued behind a spin kernel; one forward per repeat, so
    that the queued launches stay below the launch queue's depth
    and the host never waits inside the timed window)."""
    with torch.no_grad():
        device_ms, _ = timed_ms(call, [()], reps=7, iters=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            call()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 50
    print(f"[serve] {label}: {wall_ms:.4f} ms on the host clock, {device_ms:.4f} ms of device "
          f"time (idle {1 - device_ms / wall_ms:.1%}); served step {step_wall_ms:.4f} ms",
          flush=True)
    return dict(forward_wall_ms=wall_ms, forward_device_ms=device_ms, step_wall_ms=step_wall_ms)


def profile_forward(label, call, top=8, iters=3):
    """Device time of one forward by kernel name (torch.profiler over `iters`
    forwards): which launches the step's device time is made of. Returns the
    forward's device ms, its launches and the `top` kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
    from torch.autograd import DeviceType

    rows = [(e.key, getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)),
             e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    if total == 0:
        print(f"[profile] {label}: the profiler saw no device time; not measured", flush=True)
        return dict(total_ms=None, launches=None, top=[])
    print(f"[profile] {label}: {total / iters / 1e3:.4f} ms of device time per forward in "
          f"{sum(r[2] for r in rows) // iters} launches; the largest:", flush=True)
    out = []
    for name, us, count in rows[:top]:
        out.append(dict(name=name[:100], ms_per_forward=us / iters / 1e3, launches=count // iters))
        print(f"[profile]   {us / iters / 1e3:8.4f} ms  {count // iters:4d} x  {name[:100]}",
              flush=True)
    return dict(total_ms=total / iters / 1e3, launches=sum(r[2] for r in rows) // iters, top=out)


@contextlib.contextmanager
def resblock_swapped_for_plain():
    import condmdi_tpu_torch.models.unet as unet_mod
    from condmdi_tpu_torch.ops.resblock import reference_conv_gn_mish

    kernel_fn = unet_mod.fused_conv_gn_mish
    # the plain path, this run only; the plain version has no packed weight to take
    unet_mod.fused_conv_gn_mish = lambda *a, packed=None, **kw: reference_conv_gn_mish(*a, **kw)
    try:
        yield
    finally:
        unet_mod.fused_conv_gn_mish = kernel_fn


@contextlib.contextmanager
def attention_swapped_for_plain():
    """The attention kernel's launch replaced by its plain version; the autograd
    Function and its backward stay as they are."""
    import condmdi_tpu_torch.ops.attention as attn

    launch = attn._launch
    attn._launch = lambda q, k, v, heads: attn._xla_attention(q, k, v, heads)
    try:
        yield
    finally:
        attn._launch = launch


def ddim_kernel_vs_plain(dev):
    B = 2
    model = build_xl(dev, torch.float32)
    pipe = pipeline(model, schedule(20), dev, method="ddim")
    text, obs, mask = keyframe_inputs(B, 0)
    noise = seeded_noise((B, T_FRAMES, FEATS), dev)

    def run():
        return pipe.sample((B, T_FRAMES, FEATS), {"text_embed": text.to(dev)},
                           obs_x0=obs.to(dev), obs_mask=mask.to(dev), noise=noise)

    return kernel_vs_plain("ddim", f"UNet-XL f32 DDIM-20 B={B}", run, resblock_swapped_for_plain)


def reset_counts():
    from condmdi_tpu_torch.ops.attention import fused_self_attention
    from condmdi_tpu_torch.ops.quant import int8_conv1d
    from condmdi_tpu_torch.ops.resblock import fused_conv_gn_mish

    fused_conv_gn_mish.launches = 0
    fused_self_attention.launches = 0
    int8_conv1d.launches = 0


def read_counts():
    from condmdi_tpu_torch.ops.attention import fused_self_attention
    from condmdi_tpu_torch.ops.quant import int8_conv1d
    from condmdi_tpu_torch.ops.resblock import fused_conv_gn_mish

    return {"fused_conv_gn_mish": fused_conv_gn_mish.launches,
            "fused_self_attention": fused_self_attention.launches,
            "int8_conv1d": int8_conv1d.launches}


def serve_requests(pipe, requests):
    """4 concurrent requests through one MotionServer, the counts read around them."""
    from condmdi_tpu_torch.serving import MotionServer

    server = MotionServer(pipe, T_FRAMES, FEATS, max_batch=SERVE_REQUESTS, max_wait_ms=500,
                          guidance_param=GUIDANCE)
    try:
        server.warmup(buckets=(SERVE_REQUESTS,))
        reset_counts()
        t0 = time.perf_counter()
        reqs = [server.submit(r) for r in requests]
        outs = [r.result(timeout=900) for r in reqs]
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        server.shutdown()
    if server._thread.is_alive():
        raise SystemExit("the server thread did not stop")
    if not all(o.shape == (T_FRAMES, FEATS) and np.isfinite(o).all() for o in outs) \
            or float(np.std(np.stack(outs))) == 0.0:
        raise SystemExit("served motions are not finite [196, 263] arrays")
    if server.batches != [(SERVE_REQUESTS, SERVE_REQUESTS)]:
        raise SystemExit(f"requests were not coalesced into one bucket: {server.batches}")
    return dict(wall_s=wall, samples_per_s=SERVE_REQUESTS / wall, steps=SERVE_STEPS,
                batches=server.batches, launches=launches)


def check_launches(served, kernel, per_step, card, label):
    expected = per_step * SERVE_STEPS * len(served["batches"])
    got = served["launches"][kernel]
    print(f"[serve] {card}: {label}, {SERVE_STEPS}-step DDPM, CFG {GUIDANCE}, {SERVE_REQUESTS} "
          f"requests in batches {served['batches']}: wall {served['wall_s']:.3f} s, "
          f"{served['samples_per_s']:.4f} samples/s; launches {served['launches']} "
          f"({kernel} expected {per_step} x {SERVE_STEPS} x {len(served['batches'])} = "
          f"{expected})", flush=True)
    if got != expected:
        raise SystemExit(f"{kernel} launches {got} != {expected}")


def serve(dev, card):
    from condmdi_tpu_torch.serving import MotionRequest

    model = build_xl(dev, torch.bfloat16)

    def apply_fn(x, t, y, **kw):  # bf16 model, sampler math in float32
        return model(x.to(torch.bfloat16), t, y, **kw).float()

    text, obs, mask = keyframe_inputs(SERVE_REQUESTS, 1)
    served = serve_requests(pipeline(apply_fn, schedule(SERVE_STEPS), dev), [
        MotionRequest(text_embed=text[i].numpy(), obs_x0=obs[i].numpy(),
                      obs_mask=mask[i].numpy(), seed=i) for i in range(SERVE_REQUESTS)])
    check_launches(served, "fused_conv_gn_mish", 33, card, "UNet-XL bf16 keyframe")

    # one CFG-doubled forward: kernel path against plain path in bf16, then host vs device time
    B = 2 * SERVE_REQUESTS
    text, obs, mask = (a.to(dev) for a in keyframe_inputs(B, 2))
    x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=12).to(torch.bfloat16)
    t = torch.full((B,), 500, device=dev)
    y = {"text_embed": text, "uncond": torch.arange(B, device=dev) >= SERVE_REQUESTS}

    def call():
        return model(x, t, y, obs_x0=obs, obs_mask=mask)

    served["bf16_forward_max_abs_err"], served["bf16_forward_rel_rms"] = \
        bf16_forward_kernel_vs_plain(f"UNet-XL B={B}", call, resblock_swapped_for_plain)
    served.update(forward_host_vs_device(f"UNet-XL forward at B={B}", call,
                                         served["wall_s"] * 1e3 / SERVE_STEPS))
    served["profile"] = profile_forward(f"UNet-XL forward at B={B}", call)
    return served


# --------------------------------------------------------------------------- #
# phase 5: the attention kernel against plain at the transformer shapes
# --------------------------------------------------------------------------- #
def attn_bound_ms(B, T, D, H, itemsize=2) -> tuple[float, str]:
    flops = 4.0 * B * H * T * T * (D // H)  # Q.K^T and P.V
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 4 * B * T * D * itemsize / PEAK_BYTES  # q, k, v, out
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_attention(dev):
    from condmdi_tpu_torch.ops.attention import _launch, _xla_attention, attention_route

    gen = torch.Generator(device=dev).manual_seed(3)

    def qkv_views(B, T, D, dtype):
        return torch.randn((B, T, 3 * D), generator=gen, device=dev).to(dtype).chunk(3, dim=-1)

    rows = []
    for name, B, T, D, H in ATTN_SHAPES:
        row = dict(shape=name, B=B, T=T, D=D, H=H)
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            q, k, v = qkv_views(B, T, D, dtype)
            route = attention_route(B, T, H, D // H, dtype)
            with torch.no_grad():
                got = _launch(q, k, v, H)
                torch.cuda.synchronize()
                want = _xla_attention(q, k, v, H)
            err = (got.float() - want.float()).abs()
            bad = (err > tol * (1 + want.float().abs())).sum().item()
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            row[f"max_abs_err_{tag}"] = err.max().item()
            row[f"route_{tag}"] = route
            print(f"[attention] {tag} {name} B={B} T={T} D={D} H={H}, route {route}: "
                  f"max_abs_err="
                  f"{err.max().item():.3e} (tol {tol:.1e}*(1+|plain|)), {bad} outside", flush=True)
            if bad or not torch.isfinite(got).all():
                raise SystemExit(f"the attention kernel disagrees with its plain version at {row}")
        n_sets = max(2, -(-64 * 2**20 // (B * T * 3 * D * 2)))  # bf16 sets past the 50 MB L2
        sets = [qkv_views(B, T, D, torch.bfloat16) for _ in range(n_sets)]
        hd = D // H
        with torch.no_grad():
            row["ms"], row["host_ms"] = timed_ms(lambda q, k, v: _launch(q, k, v, H), sets)
            row["plain_ms"], _ = timed_ms(lambda q, k, v: _xla_attention(q, k, v, H), sets)
            heads_first = [tuple(t.view(B, T, H, hd).transpose(1, 2) for t in s) for s in sets]
            row["library_ms"], row["library_host_ms"] = timed_ms(
                F.scaled_dot_product_attention, heads_first)
        row["bound_ms"], row["bound_by"] = attn_bound_ms(B, T, D, H)
        print(f"[attention] times bf16 {name} (route {row['route_bf16']}): kernel "
              f"{row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library (SDPA) {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); host enqueue per call: kernel "
              f"wrapper {row['host_ms']:.4f} ms, SDPA {row['library_host_ms']:.4f} ms", flush=True)
        rows.append(row)
    return rows


def attention_graph_replay(dev):
    """One `mha` call of the served shape captured into a CUDA graph on a side
    stream and replayed on new contents of the same buffers: each replay must
    equal the eager call on those contents bit for bit (the same kernel on the
    same inputs), in bf16 (the resident kernel) and in float32 (the tiled one)."""
    from condmdi_tpu_torch.ops.attention import _launch, mha

    _, B, T, D, H = ATTN_SHAPES[0]
    gen = torch.Generator(device=dev).manual_seed(17)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn((B, T, 3 * D), generator=gen, device=dev).to(dtype)
        q, k, v = qkv.chunk(3, dim=-1)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph, stream=side):
            out = mha(q, k, v, H)
        for replay in range(2):
            qkv.copy_(torch.randn((B, T, 3 * D), generator=gen, device=dev).to(dtype))
            graph.replay()
            torch.cuda.synchronize()
            with torch.no_grad():
                eager = _launch(q, k, v, H)
            differs = (out != eager).sum().item()
            print(f"[attention] CUDA graph, {str(dtype).split('.')[-1]}, replay {replay + 1} on new "
                  f"contents: {differs} elements differ from the eager call, max|out| = "
                  f"{out.float().abs().max().item():.3f}", flush=True)
            if differs or not torch.isfinite(out).all() or out.float().abs().max() == 0:
                raise SystemExit("the captured attention call does not replay the eager one")


# --------------------------------------------------------------------------- #
# phases 6-9: the transformer paths
# --------------------------------------------------------------------------- #
def mdm_ddim_kernel_vs_plain(dev):
    B = 2
    model = build_mdm(dev, torch.float32)
    pipe = pipeline(lambda x, t, y, **_: model(x, t, y), schedule(20), dev, method="ddim")
    text, _, _ = keyframe_inputs(B, 0)
    noise = seeded_noise((B, T_FRAMES, FEATS), dev)

    def run():
        return pipe.sample((B, T_FRAMES, FEATS), {"text_embed": text.to(dev)}, noise=noise)

    return kernel_vs_plain("mdm", f"MDM f32 DDIM-20 B={B}", run, attention_swapped_for_plain)


def mdm_recguidance_kernel_vs_plain(dev):
    """Keyframes every 10th frame on the unconditioned MDM, imputation and
    reconstruction guidance: the guidance gradient runs through the attention
    Function's backward on the card."""
    from condmdi_tpu_torch.sampling.pipeline import build_inpainting_state

    B, steps = 2, 50
    model = build_mdm(dev, torch.float32, cond_mode="no_cond")
    pipe = pipeline(lambda x, t, y, **_: model(x, t, y), schedule(steps), dev)
    _, obs, mask = keyframe_inputs(B, 4)
    obs, mask = obs.to(dev), mask.to(dev)
    # at the CLI's default weight 5 this random model's guided trajectory is
    # chaotic: on the CPU a 1e-6 relative perturbation of the attention output
    # moved the result by 56; at 0.05 a 1e-5 one moved it by 5e-5
    inpaint = build_inpainting_state(obs, mask, imputate=True, reconstruction_guidance=True,
                                     reconstruction_weight=0.05, diffusion_steps=steps)
    noise = seeded_noise((B, T_FRAMES, FEATS), dev, seed=8)
    outs = []

    def run():
        gen = torch.Generator(device=dev).manual_seed(5)
        outs.append(pipe.sample((B, T_FRAMES, FEATS), {}, inpaint=inpaint, noise=noise,
                                generator=gen))
        return outs[-1]

    reset_counts()
    err = kernel_vs_plain("recguidance", f"MDM no_cond f32 DDPM-{steps}, imputation and "
                          f"reconstruction guidance, B={B}", run, attention_swapped_for_plain)
    launches = read_counts()["fused_self_attention"]
    kept = (outs[0][mask] - obs[mask]).abs().max().item()
    print(f"[recguidance] attention launches {launches} (expected 8 x {steps} in the kernel "
          f"run); max|sample - keyframe| on the keyframes {kept:.3e}", flush=True)
    if launches != 8 * steps:
        raise SystemExit(f"recguidance attention launches {launches} != {8 * steps}")
    if kept > 1e-6:
        raise SystemExit("imputation did not keep the keyframes")
    return err


def serve_mdm(dev, card):
    from condmdi_tpu_torch.models.text import HashTextEncoder
    from condmdi_tpu_torch.serving import MotionRequest

    model = build_mdm(dev, torch.bfloat16)

    def apply_fn(x, t, y, **_):  # MDM takes no keyframes; bf16 model, f32 sampler math
        return model(x.to(torch.bfloat16), t, y).float()

    texts = HashTextEncoder().encode(PROMPTS)
    served = serve_requests(pipeline(apply_fn, schedule(SERVE_STEPS), dev), [
        MotionRequest(text_embed=texts[i], seed=i) for i in range(SERVE_REQUESTS)])
    check_launches(served, "fused_self_attention", 8, card, "MDM bf16 text")

    # one CFG-doubled forward: kernel path against plain path in bf16, then host vs device time
    B = 2 * SERVE_REQUESTS
    x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=13).to(torch.bfloat16)
    t = torch.full((B,), 500, device=dev)
    y = {"text_embed": torch.from_numpy(np.concatenate([texts, texts])).to(dev),
         "uncond": torch.arange(B, device=dev) >= SERVE_REQUESTS}

    def call():
        return model(x, t, y)

    served["bf16_forward_max_abs_err"], served["bf16_forward_rel_rms"] = \
        bf16_forward_kernel_vs_plain(f"MDM B={B}", call, attention_swapped_for_plain)
    served.update(forward_host_vs_device(f"MDM forward at B={B}", call,
                                         served["wall_s"] * 1e3 / SERVE_STEPS))
    served["profile"] = profile_forward(f"MDM forward at B={B}", call)
    return served


def mdm_bench_batch_forward(dev, attn_rows):
    """For information: one bf16 MDM forward at the evaluation batch (B=128),
    device time by kernel, and the share of it that the 8 attention launches
    take; beside it what the share was with the first attention kernel, from
    that kernel's time at this shape (PERF.md section 6)."""
    B = 128
    model = build_mdm(dev, torch.bfloat16)
    x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=14).to(torch.bfloat16)
    t = torch.full((B,), 500, device=dev)
    text, _, _ = keyframe_inputs(B, 7)
    y = {"text_embed": text.to(dev)}
    reset_counts()
    with torch.no_grad():
        out = model(x, t, y)
    torch.cuda.synchronize()
    launches = read_counts()["fused_self_attention"]
    if launches != 8 or not torch.isfinite(out).all() or out.shape != (B, T_FRAMES, FEATS):
        raise SystemExit(f"MDM forward at B={B}: {launches} attention launches, shape {out.shape}")
    prof = profile_forward(f"MDM forward at B={B}", lambda: model(x, t, y), top=6)
    attn_ms = sum(r["ms_per_forward"] for r in prof["top"] if "attention" in r["name"])
    if prof["total_ms"]:
        before_ms = 8 * PREV_ATTENTION_BENCH_BATCH_MS
        alone = next(r for r in attn_rows if r["shape"] == "mdm_bench_batch")
        print(f"[profile] MDM forward at B={B}: attention {attn_ms:.4f} ms in the forward "
              f"({8 * alone['ms']:.4f} ms as 8 launches alone on cold inputs), "
              f"{attn_ms / prof['total_ms']:.1%} of {prof['total_ms']:.4f} ms; with the first "
              f"kernel's {before_ms:.3f} ms it was "
              f"{before_ms / (prof['total_ms'] - attn_ms + before_ms):.1%} of "
              f"{prof['total_ms'] - attn_ms + before_ms:.3f} ms", flush=True)
    prof["attention_ms"] = attn_ms
    return prof


def dit_kernel_vs_plain(dev):
    from condmdi_tpu_torch.models.dit import MDM_DiT

    B = 8
    model = perturbed(MDM_DiT(**MDM, device=dev, seed=0), dev, torch.float32)
    text, _, _ = keyframe_inputs(B, 6)
    x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=9)
    t = torch.arange(B, device=dev) * 120

    def run():
        with torch.no_grad():
            return model(x, t, {"text_embed": text.to(dev)})

    reset_counts()
    got = run()
    torch.cuda.synchronize()
    launches = read_counts()["fused_self_attention"]
    with attention_swapped_for_plain():
        want = run()
    err = (got - want).abs()
    bad = (err > F32_TOL * (1 + want.abs())).sum().item()
    print(f"[dit] MDM_DiT dit_prenorm f32 forward B={B}: max|kernel - plain| = "
          f"{err.max().item():.3e} (tol {F32_TOL:.0e}*(1+|plain|)), {bad} outside, "
          f"max|plain| = {want.abs().max().item():.3f}; attention launches {launches} "
          f"(expected 8)", flush=True)
    if bad or not torch.isfinite(got).all() or want.abs().max() == 0 or launches != 8:
        raise SystemExit("MDM_DiT: the kernel path disagrees with the plain path")
    return err.max().item()


# --------------------------------------------------------------------------- #
# phase 10: the int8 kernel against plain at every int8 shape of the main path
# --------------------------------------------------------------------------- #
def record_int8_shapes(model, x, t, y, kw):
    """(Cin, Cout, k, stride, padding, T, x channels) -> count, over the QConvs of
    one int8 UNet forward."""
    from condmdi_tpu_torch.models.unet import QConv

    counts: dict[tuple, int] = {}

    def hook(mod, args, _out):
        key = (mod.in_channels, mod.bias.shape[0], mod.weight.shape[-1], mod.stride,
               mod.padding, args[0].shape[1], args[0].shape[2])
        counts[key] = counts.get(key, 0) + 1

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, QConv)]
    with torch.no_grad():
        model(x, t, y, **kw)
    for h in handles:
        h.remove()
    return counts


def int8_inputs(B, T, cin, cout, k, form, dtype, gen, dev, xc=None):
    """x [B, T, xc >= cin] (zeros past cin), the kernel's quantized weight for a
    [cout, cin, k] conv, and the activation scale of `form`: "dynamic" (None),
    "static" (a per-tensor scale below the amax, so some values clip) or
    "per_channel" (a [Cin] scale folded into the weight codes)."""
    from condmdi_tpu_torch.ops.quant import (Quantized, activation_scale, pack_int8_weight,
                                             quantize_weight_per_channel)

    x = torch.randn((B, T, cin), generator=gen, device=dev)
    x = x * (1 + torch.rand(cin, generator=gen, device=dev))
    w = torch.randn((cout, cin, k), generator=gen, device=dev) / (cin * k) ** 0.5
    bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
    a_scale = None
    if form == "static":
        a_scale = activation_scale(0.8 * x.abs().amax())
    elif form == "per_channel":
        a_scale = activation_scale(0.8 * x.abs().amax(dim=(0, 1)))
        w = w * a_scale[None, :, None]
    wq, w_scale = quantize_weight_per_channel(w)
    x = F.pad(x, (0, (xc or cin) - cin)).to(dtype)
    return x, Quantized(wq, w_scale, bias, a_scale, pack_int8_weight(wq))


def int8_call(x, q, stride, padding, kernel=True):
    from condmdi_tpu_torch.ops.quant import int8_conv1d, plain_int8_conv1d

    pc = q.a_scale is not None and q.a_scale.ndim == 1
    if kernel:
        return int8_conv1d(x, q.wq, q.w_scale, q.bias, stride, padding, q.a_scale,
                           per_channel=pc, packed=q.packed)
    return plain_int8_conv1d(x, q.wq, q.w_scale, q.bias, stride, padding, q.a_scale, pc)


def int8_kernel_against_plain(label, x, q, stride, padding):
    """max |kernel - plain| of one call, or exit: within INT8_F32_TOL * (1 + |plain|)
    in float32, one bfloat16 ulp of |plain| in bfloat16. Returns (max error,
    whether the two are equal bit for bit)."""
    with torch.no_grad():
        got = int8_call(x, q, stride, padding).float()
        torch.cuda.synchronize()
        want = int8_call(x, q, stride, padding, kernel=False).float()
    err = (got - want).abs()
    bf16 = x.dtype == torch.bfloat16
    bad = (err > (INT8_BF16_ULP * want.abs() if bf16 else INT8_F32_TOL * (1 + want.abs()))).sum().item()
    exact = bool(torch.equal(got, want))
    print(f"[int8] {label}: max_abs_err={err.max().item():.3e} "
          f"({'1 bf16 ulp' if bf16 else f'{INT8_F32_TOL:.0e}*(1+|plain|)'}), {bad} outside, "
          f"bit-exact {exact}", flush=True)
    if bad or not torch.isfinite(got).all() or want.abs().max() == 0:
        raise SystemExit(f"the int8 kernel disagrees with its plain version: {label}")
    return err.max().item(), exact


def int8_bound_ms(B, T, t_out, cin, cout, k, itemsize=2) -> tuple[float, str]:
    """The conv's int8 operations and the function's bytes: x read once, the int8
    codes, the f32 scales and bias, the output written once (alignment channels
    are no part of the function)."""
    ops = 2.0 * B * t_out * cin * cout * k
    nbytes = B * T * cin * itemsize + cout * cin * k + 8 * cout + B * t_out * cout * itemsize
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def library_int8(x, q, lib_w, cin, k, stride, padding, cout):
    """torch.amax (dynamic) + quantize + im2col + torch._int_mm + dequant: the
    yardstick only, never called by the port. K and N are zero-padded to
    multiples of 8, which _int_mm needs (lib_w [K_pad, N_pad] is made before)."""
    B = x.shape[0]
    xf = x[..., :cin].float()
    s = q.a_scale if q.a_scale is not None else torch.clamp(xf.abs().amax(), min=1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    cols = F.pad(xq, (0, 0, padding, padding)).unfold(1, k, stride)
    t_out = cols.shape[1]
    cols = cols.reshape(B * t_out, cin * k)
    if lib_w.shape[0] != cin * k:
        cols = F.pad(cols, (0, lib_w.shape[0] - cin * k))
    acc = torch._int_mm(cols, lib_w)[:, :cout]
    scale = q.w_scale if q.a_scale is not None and q.a_scale.ndim == 1 else s * q.w_scale
    return (acc.float() * scale + q.bias).reshape(B, t_out, cout).to(x.dtype)


def library_weight(q):
    cout, cin, k = q.wq.shape
    kp, npad = -(-cin * k // 8) * 8, -(-cout // 8) * 8
    w = F.pad(q.wq.reshape(cout, cin * k), (0, kp - cin * k, 0, npad - cout))
    return w.t()  # [K_pad, N_pad], column-major, as cuBLASLt's int8 product takes it


def time_int8(B, T, cin, cout, k, stride, padding, xc, form, gen, dev, cudnn=True):
    """bf16 times of one shape: the kernel (through a weight quantized and packed
    beforehand, as the modules call it), its host enqueue, the plain version, the
    library composite, and for information the bf16 cuDNN conv the float twin
    pays; enough input sets to exceed L2."""
    one = 2 * B * T * (xc or cin) + cout * cin * k
    n_sets = max(2, -(-64 * 2**20 // one))
    sets = [int8_inputs(B, T, cin, cout, k, form, torch.bfloat16, gen, dev, xc)
            for _ in range(n_sets)]
    out = {}
    with torch.no_grad():
        out["ms"], out["host_ms"] = timed_ms(lambda x, q: int8_call(x, q, stride, padding), sets)
        out["plain_ms"], _ = timed_ms(lambda x, q: int8_call(x, q, stride, padding, False), sets)
        lib = [(x, q, library_weight(q)) for x, q in sets]
        out["library_ms"], out["library_host_ms"] = timed_ms(
            lambda x, q, w: library_int8(x, q, w, cin, k, stride, padding, cout), lib)
        if cudnn:
            conv_in = [(x[..., :cin].transpose(1, 2).contiguous(),
                        torch.randn((cout, cin, k), generator=gen, device=dev).to(torch.bfloat16),
                        q.bias.to(torch.bfloat16)) for x, q in sets]
            out["cudnn_bf16_ms"], _ = timed_ms(
                lambda x, w, b: F.conv1d(x, w, b, stride=stride, padding=padding), conv_in)
    return out


def check_int8(shapes, dev, batch=8):
    """Every int8 conv shape of one UNet-XL forward at B=8, in each activation-scale
    form and in bf16 and f32; then bf16 times in the served form (static
    per-tensor). Then MDM's four int8 QDense shapes at B=8 and B=128."""
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = []
    for (cin, cout, k, stride, pad, T, xc), count in sorted(shapes.items()):
        t_out = (T + 2 * pad - k) // stride + 1
        row = dict(cin=cin, cout=cout, k=k, stride=stride, padding=pad, T=T, t_out=t_out,
                   x_channels=xc, B=batch, per_forward=count)
        errs = {"bf16": [], "f32": []}
        exact = True
        for form in ("dynamic", "static", "per_channel"):
            for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                x, q = int8_inputs(batch, T, cin, cout, k, form, dtype, gen, dev, xc)
                err, same = int8_kernel_against_plain(
                    f"{tag} {form} x[{batch},{T},{xc}] Cin={cin} Cout={cout} k={k} s={stride}",
                    x, q, stride, pad)
                errs[tag].append(err)
                exact &= same
        row["max_abs_err_bf16"], row["max_abs_err_f32"] = max(errs["bf16"]), max(errs["f32"])
        row["bit_exact"] = exact
        row.update(time_int8(batch, T, cin, cout, k, stride, pad, xc, "static", gen, dev))
        row["bound_ms"], row["bound_by"] = int8_bound_ms(batch, T, t_out, cin, cout, k)
        print(f"[int8] times bf16 static Cin={cin} Cout={cout} k={k} s={stride} T={T}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {count} per forward; host "
              f"enqueue per call: kernel wrapper {row['host_ms']:.4f} ms, library composite "
              f"{row['library_host_ms']:.4f} ms; for information bf16 cuDNN conv "
              f"{row['cudnn_bf16_ms']:.4f} ms", flush=True)
        rows.append(row)
    dense = []
    for B in (8, 128):
        for din, dout in MDM_QDENSE:
            T = B * MDM_TOKENS
            row = dict(rows=T, din=din, dout=dout, B=B)
            for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                x, q = int8_inputs(1, T, din, dout, 1, "dynamic", dtype, gen, dev)
                row[f"max_abs_err_{tag}"], _ = int8_kernel_against_plain(
                    f"{tag} QDense B={B} rows={T} {din}->{dout}", x, q, 1, 0)
            row.update(time_int8(1, T, din, dout, 1, 1, 0, None, "dynamic", gen, dev,
                                 cudnn=False))
            row["bound_ms"], row["bound_by"] = int8_bound_ms(1, T, T, din, dout, 1)
            print(f"[int8] times bf16 dynamic QDense B={B} {din}->{dout}: kernel {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); host enqueue per call "
                  f"{row['host_ms']:.4f} ms", flush=True)
            dense.append(row)
    return rows, dense


# --------------------------------------------------------------------------- #
# phases 11 and 12: the int8 paths and mixed-step serving
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def int8_swapped_for_plain():
    """The int8 kernel's launch replaced by its plain version, this run only."""
    import condmdi_tpu_torch.ops.quant as quant

    launch = quant._launch
    quant._launch = lambda x, wq, ws, b, stride, pad, a_scale, pc, packed: \
        quant.plain_int8_conv1d(x, wq, ws, b, stride, pad, a_scale, pc)
    try:
        yield
    finally:
        quant._launch = launch


def calibrate_on_q_sample(model, B, dev, seed):
    """Static scales from q_sample states of the keyframe inputs at five timestep
    fractions (ops.quant.calibrate_act_scales)."""
    from condmdi_tpu_torch.ops.quant import calibrate_act_scales

    text, obs, mask = keyframe_inputs(B, seed)
    calibrate_act_scales(model, schedule(SERVE_STEPS).to(dev), obs.to(dev),
                         {"text_embed": text.to(dev)},
                         generator=torch.Generator(device=dev).manual_seed(seed),
                         obs_x0=obs.to(dev), obs_mask=mask.to(dev))


def int8_paths(dev, model):
    """f32 DDIM-20 at B=2 kernel path against plain path; one bf16 int8_static
    UNet-XL forward and one bf16 mdm_int8 forward at B=8, kernel against plain;
    the port's verify_trajectory against the committed golden, int8_static
    beside float."""
    from condmdi_tpu_torch import bench
    from condmdi_tpu_torch.models.unet import cast_weights

    out = {}
    B = 2
    calibrate_on_q_sample(model, B, dev, 31)
    pipe = pipeline(model, schedule(20), dev, method="ddim")
    text, obs, mask = keyframe_inputs(B, 0)
    noise = seeded_noise((B, T_FRAMES, FEATS), dev)

    def run():
        return pipe.sample((B, T_FRAMES, FEATS), {"text_embed": text.to(dev)},
                           obs_x0=obs.to(dev), obs_mask=mask.to(dev), noise=noise)

    reset_counts()
    out["ddim_max_abs_err_f32"] = kernel_vs_plain(
        "int8 ddim", f"UNet-XL int8_static f32 DDIM-20 B={B}", run, int8_swapped_for_plain)
    launches = read_counts()["int8_conv1d"]
    print(f"[int8 ddim] int8_conv1d launches in the kernel run: {launches} (expected 41 x 20)",
          flush=True)
    if launches != 41 * 20:
        raise SystemExit(f"int8 DDIM launches {launches} != {41 * 20}")

    Bf = 2 * SERVE_REQUESTS
    calibrate_on_q_sample(model, Bf, dev, 32)  # in float32, then the weights to bf16
    cast_weights(model, torch.bfloat16)
    text, obs, mask = (a.to(dev) for a in keyframe_inputs(Bf, 2))
    x = seeded_noise((Bf, T_FRAMES, FEATS), dev, seed=12).to(torch.bfloat16)
    t = torch.full((Bf,), 500, device=dev)
    y = {"text_embed": text, "uncond": torch.arange(Bf, device=dev) >= SERVE_REQUESTS}
    out["unet_bf16_forward_max_abs_err"], out["unet_bf16_forward_rel_rms"] = \
        bf16_forward_kernel_vs_plain(f"UNet-XL int8_static B={Bf}",
                                     lambda: model(x, t, y, obs_x0=obs, obs_mask=mask),
                                     int8_swapped_for_plain)

    mdm = build_mdm(dev, torch.bfloat16, precision_mode="int8")
    xm = seeded_noise((Bf, T_FRAMES, FEATS), dev, seed=13).to(torch.bfloat16)
    out["mdm_bf16_forward_max_abs_err"], out["mdm_bf16_forward_rel_rms"] = \
        bf16_forward_kernel_vs_plain(f"MDM int8 B={Bf}", lambda: mdm(xm, t, {"text_embed": text}),
                                     int8_swapped_for_plain)
    del mdm

    for which in ("unet_int8_static", "unet"):
        start = time.perf_counter()
        ok, err = bench.check_against_golden(which, bench.verify_trajectory(which, device=dev),
                                             DDIM_TOL)
        crit = "mean-relative <= 0.10" if "int8" in which else f"max-abs <= {DDIM_TOL:.0e}"
        print(f"[golden] port verify_trajectory({which!r}) f32 DDIM-20 B=2 against "
              f"tests/golden/bench_traj_{bench.golden_name(which)}.json: {err:.4e} ({crit}) -> {ok}; "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        out[f"golden_{which}"] = err
        if which != "unet" and not ok:
            raise SystemExit(f"{which}: the trajectory does not match the committed golden")
    return out


def serve_mixed(dev, card, model, float_served):
    """Calibrate the bf16 int8_static UNet-XL along one CFG 2.5 DDPM trajectory at the
    served shape, then serve phase 4's 4 keyframe requests with the float-tail
    mixed-step denoiser (k_float = 250)."""
    from condmdi_tpu_torch.diffusion import DiffusionConfig
    from condmdi_tpu_torch.models.unet import MixedStepDenoiser
    from condmdi_tpu_torch.ops.quant import calibrate_act_scales_trajectory
    from condmdi_tpu_torch.serving import MotionRequest

    def bf16_apply(m):  # bf16 model, sampler math in float32
        return lambda x, t, y, **kw: m(x.to(torch.bfloat16), t, y, **kw).float()

    text, obs, mask = keyframe_inputs(SERVE_REQUESTS, 1)
    start = time.perf_counter()
    calibrate_act_scales_trajectory(
        model, schedule(SERVE_STEPS).to(dev), DiffusionConfig(),
        (SERVE_REQUESTS, T_FRAMES, FEATS), {"text_embed": text.to(dev)},
        guidance_param=GUIDANCE, obs_x0=obs.to(dev), obs_mask=mask.to(dev),
        generator=torch.Generator(device=dev).manual_seed(100), apply_fn=bf16_apply(model))
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - start
    mixed = MixedStepDenoiser(model, K_FLOAT)
    served = serve_requests(pipeline(bf16_apply(mixed), schedule(SERVE_STEPS), dev), [
        MotionRequest(text_embed=text[i].numpy(), obs_x0=obs[i].numpy(),
                      obs_mask=mask[i].numpy(), seed=i) for i in range(SERVE_REQUESTS)])
    served["calibration_s"] = calib_s
    n = len(served["batches"])
    # the steps whose model timestep is below k_float take the float twin
    n_float = int((schedule(SERVE_STEPS).timestep_map < K_FLOAT).sum())
    want = {"int8_conv1d": 41 * (SERVE_STEPS - n_float) * n,
            "fused_conv_gn_mish": 33 * n_float * n}
    print(f"[mixed] {card}: UNet-XL int8_static + float tail (k_float={K_FLOAT}), bf16, "
          f"{SERVE_STEPS}-step DDPM, CFG {GUIDANCE}, {SERVE_REQUESTS} requests in batches "
          f"{served['batches']}: wall {served['wall_s']:.3f} s, {served['samples_per_s']:.4f} "
          f"samples/s (phase 4, bf16 float, this run: {float_served['samples_per_s']:.4f}); "
          f"calibration {calib_s:.2f} s; launches {served['launches']} (expected {want})",
          flush=True)
    for kern, count in want.items():
        if served["launches"][kern] != count:
            raise SystemExit(f"mixed-step {kern} launches {served['launches'][kern]} != {count}")

    # one CFG-doubled int8 forward of the served step: host against device time, kernels by time
    B = 2 * SERVE_REQUESTS
    text, obs, mask = (a.to(dev) for a in keyframe_inputs(B, 2))
    x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=12).to(torch.bfloat16)
    t = torch.full((B,), 500, device=dev)
    y = {"text_embed": text, "uncond": torch.arange(B, device=dev) >= SERVE_REQUESTS}

    def call():
        return model(x, t, y, obs_x0=obs, obs_mask=mask)

    served.update(forward_host_vs_device(f"UNet-XL int8_static forward at B={B}", call,
                                         served["wall_s"] * 1e3 / SERVE_STEPS))
    served["profile"] = profile_forward(f"UNet-XL int8_static forward at B={B}", call)
    return served


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
    sources = ["resblock.cu", "attention.cu", "quant.cu"]
    _build.build_all(sources)
    _build.load_resblock()
    _build.load_attention()
    _build.load_quant()
    print(f"[setup] kernels ready in {time.perf_counter() - t0:.2f} s (nvcc, in parallel: "
          + ", ".join(f"{s} {_build.build_seconds.get(s, 0.0):.2f} s" for s in sources) + ")",
          flush=True)
    for source in sources:
        seen = set()
        for line in _build.build_log.get(source, "").splitlines():
            # ptxas -v: registers and spills, one pair per instantiation, and once each any
            # note that it serialised wgmma (C7510 to C7518; C7519 only says where it put a
            # warpgroup.arrive)
            note = line.split("in the function")[0].split("in function")[0].strip()
            if "Used " in line or "spill" in line:
                print(f"[setup] ptxas {source}: {line.strip()}", flush=True)
            elif "(C75" in line and "(C7519)" not in line and note not in seen:
                seen.add(note)
                print(f"[setup] ptxas {source}: {note}", flush=True)

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
    phase_seconds = {"1 setup": time.perf_counter() - t0}

    def phase(name, fn, *args):
        """Run one phase and keep its host seconds (the whole script has a time limit)."""
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        phase_seconds[name] = time.perf_counter() - start
        return out

    rows, big_rows = phase("2 resblock kernel", check_kernel, shapes, dev)
    ddim_err = phase("3 UNet-XL DDIM", ddim_kernel_vs_plain, dev)
    served = phase("4 UNet-XL serving", serve, dev, card)
    attn_rows = phase("5 attention kernels", check_attention, dev)
    phase("5 attention CUDA graph", attention_graph_replay, dev)
    mdm_ddim_err = phase("6 MDM DDIM", mdm_ddim_kernel_vs_plain, dev)
    recg_err = phase("7 MDM guidance", mdm_recguidance_kernel_vs_plain, dev)
    served_mdm = phase("8 MDM serving", serve_mdm, dev, card)
    dit_err = phase("9 DiT forward", dit_kernel_vs_plain, dev)
    bench_forward = phase("9 MDM forward at B=128", mdm_bench_batch_forward, dev, attn_rows)

    # the int8 path's conv shapes, from one UNet-XL int8_static forward at B=8
    int8_model = build_xl(dev, torch.float32, precision_mode="int8_static")
    int8_shapes = record_int8_shapes(
        int8_model, torch.randn(8, T_FRAMES, FEATS, device=dev), torch.full((8,), 500, device=dev),
        {"text_embed": text.to(dev)}, dict(obs_x0=obs.to(dev), obs_mask=mask.to(dev)))
    if sum(int8_shapes.values()) != 41:
        raise SystemExit(f"expected 41 int8 convs per forward, found {int8_shapes}")
    int8_rows, dense_rows = phase("10 int8 kernel", check_int8, int8_shapes, dev)
    int8_out = phase("11 int8 paths", int8_paths, dev, int8_model)
    mixed = phase("12 mixed-step serving", serve_mixed, dev, card, int8_model, served)
    print("[time] host seconds by phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_seconds.items())
          + f"; {sum(phase_seconds.values()):.1f} in all", flush=True)

    def per_forward(key, shape_rows=rows):
        return sum(r[key] * r["per_forward"] for r in shape_rows)

    def bound_by(shape_rows):
        ops_bound = sum(r["bound_ms"] * r["per_forward"] for r in shape_rows
                        if r["bound_by"] == "operations")
        return "operations" if ops_bound >= per_forward("bound_ms", shape_rows) / 2 else "bytes"

    attn = next(r for r in attn_rows if r["shape"] == "mdm_served")
    kernels = [{
        "name": "fused_conv_gn_mish",
        "route": "cuda",
        "source": "condmdi_tpu_torch/csrc/resblock.cu",
        "replaces": "condmdi_tpu/ops/resblock.py:53",
        "launches": served["launches"]["fused_conv_gn_mish"],
        "max_abs_err": max(r["max_abs_err_bf16"] for r in rows),
        "max_abs_err_f32": max(r["max_abs_err_f32"] for r in rows),
        "ddim_max_abs_err_f32": ddim_err,
        # times: the 33 resblock halves of one UNet-XL forward at B=8, bf16
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": bound_by(rows),
        "library_ms": per_forward("library_ms"),
        "host_ms_per_call": per_forward("host_ms") / 33,
        "bf16_forward_max_abs_err": served["bf16_forward_max_abs_err"],
        "bf16_forward_rel_rms": served["bf16_forward_rel_rms"],
    }, {
        "name": "fused_self_attention",
        "route": "cuda",
        "source": "condmdi_tpu_torch/csrc/attention.cu",
        "replaces": "condmdi_tpu/ops/attention.py:34",
        "launches": served_mdm["launches"]["fused_self_attention"],
        "max_abs_err": max(r["max_abs_err_bf16"] for r in attn_rows),
        "max_abs_err_f32": max(r["max_abs_err_f32"] for r in attn_rows),
        "ddim_max_abs_err_f32": mdm_ddim_err,
        "recguidance_max_abs_err_f32": recg_err,
        "dit_max_abs_err_f32": dit_err,
        # times: the 8 self-attentions of one MDM forward at the served shape, bf16
        "ms": 8 * attn["ms"],
        "plain_ms": 8 * attn["plain_ms"],
        "bound_ms": 8 * attn["bound_ms"],
        "bound_by": attn["bound_by"],
        "library_ms": 8 * attn["library_ms"],
        "host_ms_per_call": attn["host_ms"],
        "bf16_forward_max_abs_err": served_mdm["bf16_forward_max_abs_err"],
        "bf16_forward_rel_rms": served_mdm["bf16_forward_rel_rms"],
    }, {
        "name": "int8_conv1d",
        "route": "cuda",
        "source": "condmdi_tpu_torch/csrc/quant.cu",
        "replaces": "condmdi_tpu/ops/quant.py:56",
        "launches": mixed["launches"]["int8_conv1d"],
        "max_abs_err": max(r["max_abs_err_bf16"] for r in int8_rows + dense_rows),
        "max_abs_err_f32": max(r["max_abs_err_f32"] for r in int8_rows + dense_rows),
        "bit_exact_at_every_conv_shape": all(r["bit_exact"] for r in int8_rows),
        "ddim_max_abs_err_f32": int8_out["ddim_max_abs_err_f32"],
        # times: the 41 int8 convs of one UNet-XL int8_static forward at B=8, bf16
        "ms": per_forward("ms", int8_rows),
        "plain_ms": per_forward("plain_ms", int8_rows),
        "bound_ms": per_forward("bound_ms", int8_rows),
        "bound_by": bound_by(int8_rows),
        "library_ms": per_forward("library_ms", int8_rows),
        "host_ms_per_call": per_forward("host_ms", int8_rows) / 41,
        "cudnn_bf16_ms_for_information": per_forward("cudnn_bf16_ms", int8_rows),
        "bf16_forward_max_abs_err": int8_out["unet_bf16_forward_max_abs_err"],
        "bf16_forward_rel_rms": int8_out["unet_bf16_forward_rel_rms"],
        "mdm_bf16_forward_rel_rms": int8_out["mdm_bf16_forward_rel_rms"],
        "golden_mean_rel_unet_int8_static": int8_out["golden_unet_int8_static"],
        "golden_max_abs_unet_float": int8_out["golden_unet"],
    }]
    previous = {"fused_conv_gn_mish": PREV_RESBLOCK_MS, "fused_self_attention": PREV_ATTENTION_MS}
    for kern in kernels[:2]:
        print(f"[kernel] before: {kern['name']} took {previous[kern['name']]} ms in its first "
              f"version (PERF.md section 6, an earlier run on an NVIDIA H100 80GB HBM3 at 700 W); "
              f"this run {kern['ms']:.4f} ms", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "shapes": rows, "shapes_b64": big_rows, "serve": served, "attention_shapes": attn_rows,
         "serve_mdm": served_mdm, "mdm_forward_b128": bench_forward,
         "int8_shapes": int8_rows, "int8_qdense": dense_rows, "int8_paths": int8_out,
         "serve_mixed": mixed, "kernels": kernels,
         "phase_seconds": phase_seconds,
         "previous_ms_from_perf_md": previous}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
