"""Drive condmdi_tpu_torch on one NVIDIA GPU and hold its kernels to their plain versions.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. setup: card name and power limit, torch/CUDA versions, the four sources
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
     at B=64 for information; then the float32 route at every shape at B=8,
     per call and timed (kernel, plain, the cuDNN f32 composite, bound, host
     enqueue), the 33 halves summed beside the first design's time;
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
     float32: the same kernel on hi and lo planes) and times as in phase 2 beside one
     scaled_dot_product_attention call (q, k, v are the column views of one
     [B, T, 3D] projection, as on the path); then one `mha` call captured in a
     CUDA graph on a side stream and replayed twice on new contents, which
     must equal the eager call bit for bit; the float32 route (route 2) at the
     same four shapes, per call and timed beside SDPA in float32 and the first
     design's time; then the streaming route (route 0, "stream") per call
     against plain at the shapes no resident route takes (STREAM_SHAPES: hd 16
     at evals.run_a2m's default width, hd 128 at T = 225 in float32 and at
     T = 512 in bf16, hd 4, 256 and 320, hd 72 at DiT-XL/2's offline batch of
     B=64, T=196 in bf16 through the pack pass), each timed (kernel, plain, SDPA,
     bound, host enqueue) with the layout it took; and one full-width MDM
     forward (latent 512, 8 layers, f32, B=4, 224 frames: T = 225) kernel path
     against plain path with exactly 8 launches on that route;
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
     bf16 cuDNN conv the float twin pays, each beside the first int8 kernel's time and
     with the tiles and split of the K steps the launch took; the same for
     MDM's four int8 QDense shapes at B=8 and B=128 (dynamic);
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
 13. UNet-XL keyframe editing under autograd, kernel against plain: keyframes
     every 10th frame, imputation and reconstruction guidance at weight 0.05
     over a 50-step respaced DDPM, f32, B=2; the guidance gradient runs
     through the resblock kernel's autograd Function (exactly 33 x 50
     launches in the kernel run);
 14. the same with the int8_static UNet-XL through the int8 kernel's autograd
     Function (exactly 41 x 50 launches);
 15. the conditional CLI through its `main` (f32, 1000-step DDPM, CFG 2.5, benchmark_sparse):
     the committed gate checkpoint (save/synthetic_unet_m, 4 samples) plain, with
     imputation and with reconstruction guidance at its default weight 5 (eager and
     host-bound: respaced to 250 of the 1000 steps, to keep the script near 15
     minutes), then
     UNet-XL at full width and depth with Flax's initialisation from --seed (pad 224,
     2 samples) in float and in int8; each run's results.npy holds the JAX CLI's keys
     and finite motions and joints, imputation keeps the observed features exactly,
     and each kernel's launches equal halves (or convs) x steps; host seconds,
     samples/s and the keyframe joint error printed;
 16. edit (benchmark_clip, imputation) and synthesize (9.8 s) through their `main` on
     MDM at the default widths with Flax's initialisation, 1000-step DDPM, 8 x 1000
     attention launches each;
 17. kernel against plain through the CLIs: UNet-XL conditional in float and in
     int8 and MDM edit at DDIM-20, the same seed (so the same x_T), within 5e-3;
     then the resblock kernel per call at every f32 shape of the gate UNet (B=8)
     and of UNet-XL at pad 224 (B=4), and the f32 attention kernel at the edit and
     synthesize shapes, each within F32_TOL of its plain version, with kernel,
     plain, library, bound and host enqueue times beside the first designs'; one
     f32 forward of each UNet on the host clock against its device time, and its
     kernels by time; the int8 kernel per call at every conv shape of the int8 XL
     CLI (f32, dynamic scale, B=4, pad 224) within INT8_F32_TOL of its plain
     version, with the tiles and split each takes and its kernel, plain, library,
     bound and host times, and that model's forward on the host clock against its
     device time;
 18. evals.run (the CondMDI keyframe protocol) through its `main` on the gate
     checkpoint: benchmark_sparse at transition length 10, guidance 1.0, seed 10, hash
     text encoder, debug mode cut to one replication of two batches of 32, the 1000-step
     DDPM, f32; the report has the JAX report's keys, finite, the gate's
     params_fingerprint 0d69067e95b7d9da and the run's mask settings; exactly
     25 x 1000 x 2 resblock launches; wall seconds and samples/s; one B=32 forward on
     the host clock against its device time and its kernels by time; then the same
     with --precision_mode int8_static --int8_float_last_k 250: the calibration
     trajectory (timed, its int8 launches counted apart), then exactly
     750 x (int8 convs a forward) x 2 int8 and 250 x 25 x 2 resblock launches;
 19. evals.run_t2m (the legacy text-only protocol) through its `main` on MDM at the
     default widths with Flax's initialisation: one batch of 32, CFG 2.5 (B=64
     forwards), 1000-step DDPM, f32; a finite report with no keyframe metrics and
     exactly 8 x 1000 attention launches; one B=64 forward's host and device time;
 20. kernel against plain through evals.run at DDIM-20 (same seed, so the same x_T
     per batch): the gate in float and in int8_static, the generated motions and
     their joints within 5e-3 (the evaluator-space motions_rel, inverse kinematics of
     the joints, by mean-relative difference), the metrics side by side; then each kernel
     per call at the new evaluation shapes: the gate's f32 resblock halves at B=32 and
     its int8 convs (f32, static scale) at B=32, f32 attention at B=64, T=197, with
     kernel, plain, library, bound and host times (reports under chiprun_out/eval/);
 21. UNet-XL training through training.train.main (the motion_abs_unet_adagn_xl card,
     keyframe-conditioned, B=64, pad 224, use_fp16 as the card sets it, the synthetic set
     cached on the card): 30 steps saved at 20 and 30 under cuDNN's deterministic
     algorithms, exactly 33 resblock launches a step; a second main resumed from the
     step-20 checkpoint to step 30, whose step-30 parameters and EMA must equal the first
     run's bit for bit; the step-30 EMA npz sampled by the conditional CLI at DDIM-20
     (finite, its fingerprint the one training wrote); a third main of 30 steps under
     cuDNN's defaults, as the CLI runs, for steps/s (steps 5-29 over their host time) and
     peak memory; the mean loss over the first and last 10 steps; one step of that run
     on the host clock against its device time, split by CUDA events into the
     kernel's forwards, the rest of the forward, the halves' plain recompute and
     gradient, the rest of the backward and the optimizer, and by kernel
     (torch.profiler); the f32 resblock kernel per call at the 13 training shapes (B=64)
     with its kernel, plain, library and bound times;
 22. MDM training through main (the motion_mdm card, B=64, dropout and condition dropout
     at 0.1): 20 steps, exactly 8 attention launches a step, finite losses, steps/s
     (steps 5-19 over their host time) and one step's split;
 23. one train step of each model through the kernel and through the plain version (the
     swap helpers), from the same weights, generator states and the training run's warmed
     AdamW state (its moments and count, so that the update is a smooth function of the
     gradient): the loss, each parameter's gradient and each parameter's update within
     stated tolerances (TRAIN_*_TOL); between the two, every kernel call of
     a forward on the weights the kernel step's optimizer just updated against its plain
     version (F32_TOL) and that forward's output against the plain path's (DDIM_TOL);
 24. CUDA graphs against eager, in this process: every SamplePipeline,
     MotionServer bucket and training.train step above replays its sampler step or train
     step from CUDA graphs (the launch counters count a replay's launches); here each path
     runs once with graphs and once with cuda_graphs=False (SamplePipeline, TrainLoop):
     served UNet-XL bf16 and MDM (phases 4 and 8), the int8 mixed step (phase 12), the gate
     `conditional` CLI (plain, 4 samples), evals.run on the gate (one batch of 32), the
     gate configuration's training (save/synthetic_unet_m/args.json, 50 steps, 2
     dispatches of 25) and 6 steps each of UNet-XL and MDM training (cuDNN's deterministic
     algorithms for the training runs, then 20, 5 and 20 more steps of each run's step
     function, timed); for each: samples/s or steps/s both ways, host ms a step against
     device ms (one step behind a spin kernel; the profiler's kernel time for an eager
     train step) and the idle share, the host's launch calls and the card's
     kernels a step (torch.profiler), and whether the graph run equals the eager run bit
     for bit (the trained parameters and EMA for training), which it must, with the same
     exact launch counts both ways;
 25. the GMD trajectory model (traj_unet_adagn_swx at full width, pad 224, f32): every
     resblock half of its forward at B = 2 and 32 (group widths 8, 16 and 32, a first
     layer of 4 channels in a row of 8) kernel against plain and timed as phase 17's f32
     rows; the xz_only model's first half (2 channels); one guided step's gradient with
     respect to x, kernel path against plain path;
 26. generate_gmd through its main at full width (the trajectory model and the UNet-XL abs
     motion card, Flax's initialisation from --seed, unet_zero off, a 100-step DDPM (the
     CLI's 1000 cut to keep the script near 15 minutes), the default
     classifier_scale 100, 2 prompts) in the modes kps, sdf, trajectory and
     mdm_legacy: samples/s, exact launches, results.npy with the JAX CLI's keys, finite;
     kps/sdf's stage 2 holding the stage-1 trajectory on channels 0:4 at every step with
     imputation on, trajectory/mdm_legacy's motion holding the imputed p2p trajectory; each
     guided and replayed stage's host ms a step against its device ms; then each mode
     kernel path against plain path through the CLI at 20 steps (DDIM_TOL);
 27. evals.run_condition through its main: one batch of 32, one replication, the 100-step
     DDPM for both models; the committed JAX report's keys, finite, a 5-entry traj_error,
     exact launches, samples/s and each stage's host and device ms a step;
 28. PLMS (orders 2 and 4) on the gate checkpoint at conditional's shapes (4 samples,
     CFG 2.5, 100 steps): graphs against eager bit for bit with the same launches, kernel
     against plain, samples/s, host and device ms a step; the DDIM reverse ODE from a
     DDPM-100 sample of the same model (no keyframe observed) back to x_T, kernel against
     plain within DDIM_TOL * max|plain| (the ODE amplifies differences as it grows |x|);
 29. evals.run_a2m through its main on HumanAct12 (synthetic, 12 actions; a random-init GRU
     classifier) at the MDM paper's action-to-motion width (latent 512, 8 layers, ff 1024, 4
     heads: hd 128, attention route wgmma_f32 at T = 61), the 1000-step DDPM, one batch of
     32, 5 replications: the committed JAX report's keys, finite, exact launches (8 a
     forward), samples/s, host ms a step against device ms; one replication with graphs
     and with cuda_graphs=False, bit for bit; then through main at 20 steps, kernel against
     plain (DDIM_TOL);
 30. evals.run_a2m --dataset uestc (40 actions, ST-GCN on the card) at the same width; then
     HumanAct12 at the CLIs' default widths (latent 64, 2 layers: hd 16, the streaming
     route), and at 20 steps kernel against plain; the f32 attention at both a2m
     shapes per call against plain, timed beside SDPA and the bound;
 31. evals.run_unconstrained through its main at phase 29's width (MDM no_cond, ST-GCN
     features, FID / KID / precision-recall / diversity): the committed report's keys,
     finite, exact launches, samples/s;
 32. the model variants at full width, f32: MDM gru (8 layers, B=32, 60 frames) sampled
     over 100 DDPM steps through SamplePipeline with graphs and without, bit for bit; MDM
     trans_enc_large one forward kernel against plain (F32_TOL) and DDIM-20 (DDIM_TOL); a
     UNet-XL action forward (150 features, pad 64) kernel against plain (DDIM_TOL);
 33. UNet-XL unconstrained (no_cond) with LinearAttention trained through training.train.main
     (the motion_abs_unet_adagn_xl card, B=64, 10 steps): exact launches (33 a step), finite
     losses, steps/s; conditional from its step-10 EMA (2 samples, 1000-step DDPM, the JAX
     CLI's keys, finite); the f32 halves at B=64; one step through the kernels against the
     plain path as in phase 23;
 34. training_losses with the SMPL terms (rcxyz, fc; get_xyz a Rotation2xyz over
     SMPLModel.random_init with SMPL's 6890 vertices) on the action MDM at the a2m width
     (latent 512, 8 layers, B=32, 60 frames, rot6d 25 x 6): one step through the attention
     kernel against the plain path (loss, every gradient, as phase 23), then 3 AdamW steps
     with exact launches (8 a step) and host ms against device ms a step;
 35. joints2smpl: render_mesh_cli on sample 0 of phase 15's gate conditional results.npy
     (196 frames) over the same synthetic body, 300 Adam steps replayed from a CUDA graph;
     the same fit eagerly, bit for bit; the loss drop; 196 .obj files (under .chipwork/);
 36. AMASS: UNet-XL with 764 features, keyframe-conditioned (the first half's Cin 1528,
     k*Cin = 7640), pad 128, B=8 (no text, so no CFG): SyntheticAMASSDataset clips under a
     joint-level keyframe mask expanded by amass_joint_to_full_mask through the 1000-step
     DDPM from graphs (33 x 1000 launches); DDIM-20 kernel against plain (DDIM_TOL); every
     resblock shape per call against plain and timed in f32 (kernel, plain, library,
     bound), the first half also in bf16 at B = 8, 1, 3; fields_from_poses and dict_to_xyz
     on the card against the CPU;
 37. the file-backed datasets: a HumanML3D tree (40 clips, abs-root and relative features
     from the synthetic set, a tagged sub-clip each) and a KIT tree written under
     .chipwork/; training.train through main on the HumanML3D tree (UNet-XL keyframe card,
     B=16, 5 steps, --use_random_proj true --augment_type full; 33 launches a step);
 38. evals.parity through its main on mock assets written under .chipwork/ (GloVe, a T2M
     evaluator at its real widths, 36 clips, a released-layout .pt from random UNet-XL
     weights with a 50-step schedule in its args.json): one replication of one batch of
     32, CFG 2.5; the verdict blocked_expected with the template's nulls; exact launches;
 39. parallel/ at world size 1 on NCCL: generate_eval_batch with a 1-rank mesh against the
     call without (bit for bit), a data-parallel train step replayed from its two graphs
     against the plain step replayed from its graph (bit for bit, 8 steps; their wall ms), the
     tensor-parallel UNet-XL and MDM forwards on a 1x1 mesh against the plain forwards; one
     card shows no more;
 40. wide and long resblock halves, the split route (groups wider than 128 channels,
     lengths past a cluster of 8 tiles): per call against plain at groups of 136, 256 and
     512 and at T = 1025, 1280, 2048 and 4096 in both types, with AdaGN and the residual
     and without, two launches bit for bit; the keyframe UNet-XL at --latent_dim 1024 (pad
     224, groups of 256) built through create_model_and_diffusion: an f32 forward at B=4
     and a bf16 forward at B=8 against the plain path (33 launches, every one on the split
     route), a DDIM-20 run through GaussianDiffusion.p_mean_variance against plain,
     recover_from_rot on its motion on the card against the CPU; UNet-XL at --unet_pad_to
     1280, B=2, a forward in each type against plain; every half of those four forwards per
     call against plain and timed (kernel, plain, library, bound, host), summed;
 41. the float32 dense kernel (csrc/dense.cu, the tf32x3 route of MDM's encoder
     projections): per call at the four projections at M = 64 x 197 (evals.run_t2m's
     batch), 32 x 61 (a2m) and 4 x 197 (edit), with and without bias, its largest error
     against a float64 product at most DENSE_ERR_RATIO times cuBLAS float32's (TF32
     off) and cuBLAS in TF32 past it; times at M = 64 x 197 (kernel, plain, cuBLAS
     float32 as library, bound at three TF32 products, host enqueue); a sweep of M
     against cuBLAS (the rows from which the kernel wins: ops/dense.py `MIN_ROWS`);
     MDM forwards at B=64, f32 with 32 launches against the same forward on cuBLAS,
     bf16 with none (`python3 chip_smoke.py dense` runs this phase alone);
 42. a {"kernels": [...]} line (the four kernels, and the attention's streaming
     route beside them), the card line, and the final {"ok": true, ...}.

Per-shape results also go to chiprun_out/chip_smoke.json (`python3 resblock_probe.py
f32` times the float32 rows of phases 2, 5 and 17 alone). Imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
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
# H100 SXM dense TF32 tensor-core rate: the card's fastest for float32 inputs, so the
# least time of a float32 function (the f32 routes do three bf16 products on the tensor
# cores, at most 989/3 TFLOP/s; float32 outside the tensor cores is 67)
PEAK_F32_FLOPS = 495e12
PEAK_FLOPS = {torch.bfloat16: PEAK_BF16_FLOPS, torch.float32: PEAK_F32_FLOPS}
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
BF16_TOL = 2.0 ** -7      # |kernel - plain| <= tol * (1 + |plain|): ~2 bf16 ulps
F32_TOL = 5e-4            # hi+lo bf16 split keeps ~16 mantissa bits
DDIM_TOL = 5e-3           # max |kernel path - plain path| over a whole f32 sampler run
# phase 20: the evaluator-space motions (inverse kinematics of the joints), kernel path
# against plain, as tests/test_torch_eval_cli.py holds them against JAX
REL_MEAN_TOL, REL_SHARE_TOL = 1e-4, 1e-3
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
# What the first versions of the kernels took, for the "before" lines only
# (PERF.md section 6, measured with this script's method; NVIDIA H100 80GB HBM3,
# 700 W). Not measured by this run, so not part of the kernels line.
PREV_RESBLOCK_MS = 17.34   # the 33 halves of one UNet-XL forward at B=8, bf16
PREV_ATTENTION_MS = 0.368  # the 8 self-attentions of one MDM forward at B=8, bf16
PREV_ATTENTION_BENCH_BATCH_MS = 0.290  # one self-attention at B=128, same kernel and card
# The first int8 kernel (mma.sync, one CTA per batch item and 64 rows), bf16, static
# scale, B=8: the 41 convs of one UNet-XL forward and each conv shape, keyed
# (Cin, Cout, k, stride, T in); MDM's QDense (Din, Dout, B), dynamic
PREV_INT8_MS = 1.6347
PREV_INT8_SHAPE_MS = {
    (526, 1024, 5, 1, 200): 0.0491, (526, 1024, 1, 1, 200): 0.0214,
    (1024, 1024, 5, 1, 200): 0.0764, (1024, 1024, 5, 1, 100): 0.0412,
    (1024, 1024, 5, 1, 50): 0.0339, (1024, 1024, 5, 1, 25): 0.0330,
    (2048, 1024, 5, 1, 100): 0.0719, (2048, 1024, 5, 1, 50): 0.0583,
    (2048, 1024, 5, 1, 25): 0.0569, (2048, 1024, 1, 1, 100): 0.0269,
    (2048, 1024, 1, 1, 50): 0.0224, (2048, 1024, 1, 1, 25): 0.0207,
    (1024, 1024, 3, 2, 200): 0.0362, (1024, 1024, 3, 2, 100): 0.0284,
    (1024, 1024, 3, 2, 50): 0.0269, (1024, 263, 1, 1, 200): 0.0199,
}
PREV_QDENSE_MS = {
    (512, 1536, 8): 0.0432, (512, 512, 8): 0.0324, (512, 1024, 8): 0.0369, (1024, 512, 8): 0.0399,
    (512, 1536, 128): 0.3636, (512, 512, 128): 0.1757, (512, 1024, 128): 0.2642,
    (1024, 512, 128): 0.2803,
}
# The float32 routes' first designs, for the "before" lines only: the first mma.sync
# resblock route (the halves of one forward, summed, keyed by the forward) and the first
# tiled attention route (one launch, keyed by shape). Measured with this script's
# f32 rows (`python3 resblock_probe.py f32`) run on the tree before the redesign, in
# the same call as the redesigned routes' first timing (PERF.md section 6;
# NVIDIA H100 80GB HBM3, 700.00 W). Not measured by this run, so not part of the
# kernels line.
PREV_F32_RESBLOCK_MS = {"UNet-XL pad 200": 22.334, "gate UNet": 2.816, "UNet-XL pad 224": 22.504}
PREV_F32_ATTENTION_MS = {"mdm_served": 0.0619, "mdm_bench_batch": 0.5225, "dit_trans_dec": 0.0619,
                         "ragged": 0.0103, "edit": 0.0627, "synthesize": 0.0616}
# The first tiled attention kernel at the one streaming shape it served on a path
# (evals.run_a2m at the JAX CLIs' width, f32; PERF.md section 6, an earlier run on an
# NVIDIA H100 80GB HBM3 at 700 W); the others it refused or was never timed at.
PREV_STREAM_MS = {("a2m_cli_default", "f32"): 0.0076}
GUIDANCE_STEPS, GUIDANCE_WEIGHT = 50, 0.05  # phases 7, 13, 14
SERVE_REQUESTS, SERVE_STEPS, GUIDANCE = 4, 1000, 2.5
MDM = dict(njoints=FEATS, latent_dim=512, ff_size=1024, num_layers=8, num_heads=4)  # bench.py mdm
MDM_TOKENS = T_FRAMES + 1  # the frames and the conditioning token
ATTN_SHAPES = [  # (name, B, T, D, H)
    ("mdm_served", 8, MDM_TOKENS, 512, 4),     # 4 requests x CFG
    ("mdm_bench_batch", 128, MDM_TOKENS, 512, 4),
    ("dit_trans_dec", 8, T_FRAMES, 512, 4),    # no conditioning token in the sequence
    ("ragged", 3, 25, 128, 2),                 # hd 64, one ragged key tile
]
STREAM_SHAPES = [  # (name, B, T, D, H, types): route 0's shapes, where no resident route fits
    ("a2m_cli_default", 32, 61, 64, 4, (torch.float32,)),  # evals.run_a2m, the JAX CLIs' width
    ("mdm_f32_225", 4, 225, 512, 4, (torch.float32,)),     # MDM at 224 frames, edit's B
    ("t2m_f32_225", 64, 225, 512, 4, (torch.float32,)),    # the same at run_t2m's B
    ("bf16_long", 8, 512, 512, 4, (torch.bfloat16,)),      # served MDM past route 1's T <= 448
    ("bf16_long_b128", 128, 512, 512, 4, (torch.bfloat16,)),
    ("hd4", 8, 197, 16, 4, (torch.bfloat16, torch.float32)),  # --latent_dim 16
    ("hd256", 8, 197, 1024, 4, (torch.bfloat16,)),         # --latent_dim 1024
    ("hd320_f32", 2, 197, 1280, 4, (torch.float32,)),      # O's columns in two blocks
    ("dit_xl", 64, 196, 1152, 16, (torch.bfloat16,)),      # DiT-XL/2 offline, hd 72, packed
]
STREAM_PLAN_KEYS = ("chunk_cols", "chunks_a_block", "column_blocks", "depth_chunks", "consumers",
                    "q_resident", "stages", "smem_bytes")
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


def bound_ms(B, T, cin, cout, ada, res, k=5, dtype=torch.bfloat16) -> tuple[float, str]:
    """The conv's operations at the peak rate of `dtype` and the function's bytes
    (alignment channels are no part of the function and are not counted)."""
    flops = 2.0 * B * T * cin * cout * k
    elems = B * T * cin + k * cin * cout + 3 * cout + B * T * cout
    elems += (2 * B * cout if ada else 0) + (B * T * cout if res else 0)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], elems * dtype.itemsize / PEAK_BYTES
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


def time_kernel(B, T, cin, cout, ada, res, xc, gen, dev, library=True, dtype=torch.bfloat16):
    """Times of one shape (bf16 unless `dtype` says otherwise): the kernel
    through a cached packed weight (as the modules call it; float32 takes the
    weight as it is), its host enqueue, the plain version and the library
    composite; enough input sets to exceed L2."""
    from condmdi_tpu_torch.ops.resblock import (PackedConvWeight, fused_conv_gn_mish,
                                                reference_conv_gn_mish)

    one = dtype.itemsize * (B * T * cin + cout * cin * 5)  # bytes of x and w
    n_sets = max(2, -(-64 * 2**20 // one))
    cases = [make_case(B, T, cin, cout, ada, res, dtype, gen, dev, xc)
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


def f32_resblock_rows(name, shapes, B, dev, seed=23):
    """`resblock_rows` in float32."""
    return resblock_rows(name, shapes, B, dev, torch.float32, seed)


def resblock_rows(name, shapes, B, dev, dtype, seed=23):
    """The kernel at each resblock shape of one forward at batch B in `dtype`: the
    kernel against plain per call (F32_TOL or BF16_TOL), then kernel, plain,
    library and bound times, the host enqueue and the route the plan takes; the
    halves of the forward summed (float32 beside the first design's time,
    PREV_F32_RESBLOCK_MS)."""
    from condmdi_tpu_torch.ops.resblock import resblock_plan

    tag = "f32" if dtype == torch.float32 else "bf16"
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for (cin, cout, T, ada, res, xc), count in sorted(shapes.items()):
        row = dict(model=name, cin=cin, cout=cout, T=T, B=B, adagn=ada, res=res, x_channels=xc,
                   per_forward=count, route=resblock_plan(B, T, cin, cout, dtype).route)
        row[f"max_abs_err_{tag}"] = kernel_against_plain(B, T, cin, cout, ada, res, xc, dtype,
                                                         tol, gen, dev)
        row.update(time_kernel(B, T, cin, cout, ada, res, xc, gen, dev, dtype=dtype))
        row["bound_ms"], row["bound_by"] = bound_ms(B, T, cin, cout, ada, res, dtype=dtype)
        print(f"[{tag} resblock] {name} B={B} {cin}->{cout} T={T} adagn={ada} res={res} "
              f"x{count} ({row['route']} route): kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library (cuDNN {tag} composite) {row['library_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), host enqueue "
              f"{row['host_ms']:.4f} ms", flush=True)
        rows.append(row)
    halves = sum(r["per_forward"] for r in rows)
    total = {k: sum(r[k] * r["per_forward"] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    total["host_ms_per_call"] = sum(r["host_ms"] * r["per_forward"] for r in rows) / halves
    first = PREV_F32_RESBLOCK_MS.get(name) if dtype == torch.float32 else None
    print(f"[{tag} resblock] {name}, the {halves} halves of one {tag} forward at B={B}: kernel "
          f"{total['ms']:.4f} ms{f' (first design: {first} ms)' if first else ''}, plain "
          f"{total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} ms, bound "
          f"{total['bound_ms']:.4f} ms, host enqueue {total['host_ms_per_call']:.4f} ms a call",
          flush=True)
    return dict(rows=rows, halves=halves, **total)


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
        before = read_counts()
        t0 = time.perf_counter()
        want = run()
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in read_counts().items()}
    if any(launched.values()):  # a graph captured on the kernels must not replay here
        raise SystemExit(f"{label}: the plain path launched kernels {launched}")
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


def profile_forward(label, call, top=8, iters=3, grad=False):
    """Device time of one forward (or, with `grad`, one train step) by kernel name
    (torch.profiler over `iters` calls): which launches the step's device time is
    made of. Returns the call's device ms, its launches and the `top` kernels by
    time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.enable_grad() if grad else torch.no_grad():
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


def serve_requests(pipe, requests, outputs=None):
    """4 concurrent requests through one MotionServer, the counts read around them;
    the motions are appended to `outputs` where it is given."""
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
    if outputs is not None:
        outputs.extend(outs)
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
def attn_bound_ms(B, T, D, H, dtype=torch.bfloat16) -> tuple[float, str]:
    flops = 4.0 * B * H * T * T * (D // H)  # Q.K^T and P.V
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = 4 * B * T * D * dtype.itemsize / PEAK_BYTES  # q, k, v, out
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


def f32_attention_rows(dev, cases, seed=31):
    """The float32 route at each (name, B, T, D, H): the kernel against plain per
    call (F32_TOL), then kernel, plain, SDPA in float32 and bound times and the
    host enqueue, beside the first design's time (PREV_F32_ATTENTION_MS)."""
    from condmdi_tpu_torch.ops.attention import _launch, _xla_attention, attention_route

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for name, B, T, D, H in cases:
        def views():  # q, k, v: column views of one [B, T, 3D] projection, as on the path
            return torch.randn((B, T, 3 * D), generator=gen, device=dev).chunk(3, dim=-1)

        q, k, v = views()
        with torch.no_grad():
            got = _launch(q, k, v, H)
            torch.cuda.synchronize()
            want = _xla_attention(q, k, v, H)
        err = (got - want).abs()
        bad = (err > F32_TOL * (1 + want.abs())).sum().item()
        if bad or not torch.isfinite(got).all():
            raise SystemExit(f"f32 attention at the {name} shape disagrees with its plain version")
        sets = [views() for _ in range(max(2, -(-64 * 2**20 // (B * T * 3 * D * 4))))]
        hd = D // H
        row = dict(shape=name, B=B, T=T, D=D, H=H,
                   route=attention_route(B, T, H, hd, torch.float32),
                   max_abs_err_f32=err.max().item())
        with torch.no_grad():
            row["ms"], row["host_ms"] = timed_ms(lambda q, k, v: _launch(q, k, v, H), sets)
            row["plain_ms"], _ = timed_ms(lambda q, k, v: _xla_attention(q, k, v, H), sets)
            heads_first = [tuple(t.view(B, T, H, hd).transpose(1, 2) for t in s) for s in sets]
            row["library_ms"], row["library_host_ms"] = timed_ms(
                F.scaled_dot_product_attention, heads_first)
        row["bound_ms"], row["bound_by"] = attn_bound_ms(B, T, D, H, dtype=torch.float32)
        print(f"[f32 attention] {name} B={B} T={T} D={D} H={H} (route {row['route']}): "
              f"max_abs_err {row['max_abs_err_f32']:.3e} (tol {F32_TOL:.0e}*(1+|plain|)); kernel "
              f"{row['ms']:.4f} ms"
              + (f" (first design: {PREV_F32_ATTENTION_MS[name]} ms)"
                 if name in PREV_F32_ATTENTION_MS else "")
              + f", plain "
              f"{row['plain_ms']:.4f} ms, SDPA f32 {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); host enqueue: kernel wrapper "
              f"{row['host_ms']:.4f} ms, SDPA {row['library_host_ms']:.4f} ms", flush=True)
        rows.append(row)
    return rows


def attention_graph_replay(dev):
    """One `mha` call of the served shape captured into a CUDA graph on a side
    stream and replayed on new contents of the same buffers: each replay must
    equal the eager call on those contents bit for bit (the same kernel on the
    same inputs), in bf16 (the resident kernel) and in float32 (its split pass
    and the resident kernel on hi and lo planes behind it)."""
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


def stream_rows(dev, seed=37):
    """The streaming route at each of STREAM_SHAPES and types: the kernel against
    plain per call (BF16_TOL / F32_TOL), then kernel, plain, SDPA and bound times
    and the host enqueue, with the layout the launch took (csrc/attention.cu
    `condmdi_attention_stream_plan`) and whether it read q, k, v in place."""
    import ctypes

    from condmdi_tpu_torch.ops import _build
    from condmdi_tpu_torch.ops.attention import (_DTYPES, _launch, _xla_attention,
                                                 attention_route, stream_packs)

    lib = _build.load_attention()
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for name, B, T, D, H, types in STREAM_SHAPES:
        hd = D // H
        for dtype in types:
            def views():  # column views of one [B, T, 3D] projection, as on the path
                return torch.randn((B, T, 3 * D), generator=gen, device=dev).to(dtype).chunk(
                    3, dim=-1)

            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
            route = attention_route(B, T, H, hd, dtype)
            q, k, v = views()
            with torch.no_grad():
                got = _launch(q, k, v, H)
                torch.cuda.synchronize()
                want = _xla_attention(q, k, v, H)
            err = (got.float() - want.float()).abs()
            bad = (err > tol * (1 + want.float().abs())).sum().item()
            plan = (ctypes.c_int * 8)()
            if lib.condmdi_attention_stream_plan(B, T, H, hd, _DTYPES[dtype][0], plan) != 0:
                raise SystemExit(f"no streaming layout for {name}")
            row = dict(shape=name, B=B, T=T, D=D, H=H, dtype=tag, route=route,
                       max_abs_err=err.max().item(), in_place=not stream_packs(lib, q, k, v, H),
                       plan=dict(zip(STREAM_PLAN_KEYS, plan)))
            if route != "stream" or bad or not torch.isfinite(got).all():
                raise SystemExit(f"the streaming route disagrees with its plain version at {row} "
                                 f"({bad} outside)")
            sets = [views() for _ in range(max(2, -(-64 * 2**20 // (B * T * 3 * D * dtype.itemsize))))]
            with torch.no_grad():
                row["ms"], row["host_ms"] = timed_ms(lambda q, k, v: _launch(q, k, v, H), sets)
                row["plain_ms"], _ = timed_ms(lambda q, k, v: _xla_attention(q, k, v, H), sets)
                heads_first = [tuple(t.view(B, T, H, hd).transpose(1, 2) for t in s) for s in sets]
                row["library_ms"], row["library_host_ms"] = timed_ms(
                    F.scaled_dot_product_attention, heads_first)
            row["bound_ms"], row["bound_by"] = attn_bound_ms(B, T, D, H, dtype=dtype)
            before = PREV_STREAM_MS.get((name, tag))
            print(f"[stream] {tag} {name} B={B} T={T} D={D} H={H} (hd {hd}; "
                  f"{'in place' if row['in_place'] else 'packed'}; {row['plan']}): max_abs_err "
                  f"{row['max_abs_err']:.3e} (tol {tol:.1e}*(1+|plain|)); kernel {row['ms']:.4f} ms"
                  + (f" (the first tiled kernel: {before} ms)" if before else "")
                  + f", plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); host enqueue: kernel wrapper "
                  f"{row['host_ms']:.4f} ms, SDPA {row['library_host_ms']:.4f} ms", flush=True)
            rows.append(row)
    return rows


def mdm_225_forward(dev):
    """One full-width MDM forward (bench.py's mdm: latent 512, 8 layers, 4 heads,
    hd 128) in float32 at B=4 and 224 frames, T = 225 with the condition token,
    one row past route 2: the counts set to 0 just before, exactly 8 launches,
    all on the streaming route; the kernel path against the plain path."""
    from condmdi_tpu_torch.ops.attention import attention_route

    B, frames = 4, 224
    route = attention_route(B, frames + 1, MDM["num_heads"], MDM["latent_dim"] // MDM["num_heads"],
                            torch.float32)
    model = build_mdm(dev, torch.float32)
    x = seeded_noise((B, frames, FEATS), dev, seed=41)
    t = torch.full((B,), 500, device=dev)
    y = {"text_embed": keyframe_inputs(B, 9)[0].to(dev)}
    reset_counts()
    with torch.no_grad():
        got = model(x, t, y)
    torch.cuda.synchronize()
    launches = read_counts()["fused_self_attention"]
    with torch.no_grad(), attention_swapped_for_plain():
        want = model(x, t, y)
    err = (got - want).abs().max().item()
    print(f"[stream] MDM f32 forward, B={B}, {frames} frames (T = {frames + 1}, route {route}): "
          f"{launches} attention launches (expected 8); max|kernel - plain| = {err:.3e} (tol "
          f"{DDIM_TOL:.0e}), max|plain| = {want.abs().max().item():.3f}", flush=True)
    if route != "stream" or launches != 8 or got.shape != (B, frames, FEATS) \
            or not torch.isfinite(got).all() or err > DDIM_TOL or want.abs().max() == 0:
        raise SystemExit(f"MDM at T = {frames + 1}: route {route}, {launches} launches, error {err}")
    return dict(B=B, T=frames + 1, route=route, launches=launches, max_abs_err=err)


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

    B, steps = 2, GUIDANCE_STEPS
    model = build_mdm(dev, torch.float32, cond_mode="no_cond")
    pipe = pipeline(lambda x, t, y, **_: model(x, t, y), schedule(steps), dev)
    _, obs, mask = keyframe_inputs(B, 4)
    obs, mask = obs.to(dev), mask.to(dev)
    # at the CLI's default weight 5 this random model's guided trajectory is
    # chaotic: on the CPU a 1e-6 relative perturbation of the attention output
    # moved the result by 56; at 0.05 a 1e-5 one moved it by 5e-5
    inpaint = build_inpainting_state(obs, mask, imputate=True, reconstruction_guidance=True,
                                     reconstruction_weight=GUIDANCE_WEIGHT, diffusion_steps=steps)
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


def time_int8(B, T, cin, cout, k, stride, padding, xc, form, gen, dev, cudnn=True,
              dtype=torch.bfloat16):
    """Times of one shape, x in `dtype` (bf16 unless said): the kernel (through a
    weight quantized and packed beforehand, as the modules call it), its host
    enqueue, the plain version, the library composite, and for information the
    bf16 cuDNN conv the float twin pays; enough input sets to exceed L2."""
    one = dtype.itemsize * B * T * (xc or cin) + cout * cin * k
    n_sets = max(2, -(-64 * 2**20 // one))
    sets = [int8_inputs(B, T, cin, cout, k, form, dtype, gen, dev, xc)
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


def int8_plan(B, T, cin, cout, k, stride, padding, dev):
    """The tiles and split of the K steps a launch takes on this card (the
    library's own plan, condmdi_int8_conv1d_plan)."""
    import ctypes

    from condmdi_tpu_torch.ops import _build

    out = (ctypes.c_int * 5)()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = _build.load_quant().condmdi_int8_conv1d_plan(B, T, -(-cin // 128) * 128, cout, k, stride,
                                                       padding, sms, out)
    if err:
        raise SystemExit(f"condmdi_int8_conv1d_plan failed: {err}")
    return dict(zip(("t_pad", "m_tiles", "n_tiles", "split", "steps"), list(out)))


def plan_text(plan):
    return (f"tiles {plan['m_tiles']} x {plan['n_tiles']} of 128 x 128, {plan['steps']} K steps "
            f"split {plan['split']} ways, {plan['m_tiles'] * plan['n_tiles'] * plan['split']} CTAs")


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
        row["plan"] = int8_plan(batch, T, cin, cout, k, stride, pad, dev)
        print(f"[int8] times bf16 static Cin={cin} Cout={cout} k={k} s={stride} T={T}: kernel "
              f"{row['ms']:.4f} ms (before: {PREV_INT8_SHAPE_MS.get((cin, cout, k, stride, T))} ms "
              f"with the first int8 kernel), plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{count} per forward; {plan_text(row['plan'])}; host enqueue per call: kernel "
              f"wrapper {row['host_ms']:.4f} ms, library composite {row['library_host_ms']:.4f} ms; "
              f"for information bf16 cuDNN conv {row['cudnn_bf16_ms']:.4f} ms", flush=True)
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
            row["plan"] = int8_plan(1, T, din, dout, 1, 1, 0, dev)
            print(f"[int8] times bf16 dynamic QDense B={B} {din}->{dout}: kernel {row['ms']:.4f} ms "
                  f"(before: {PREV_QDENSE_MS.get((din, dout, B))} ms with the first int8 kernel), plain "
                  f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); {plan_text(row['plan'])}; host "
                  f"enqueue per call {row['host_ms']:.4f} ms", flush=True)
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


def unet_recguidance_kernel_vs_plain(dev, precision_mode):
    """Keyframes every 10th frame on UNet-XL, imputation and reconstruction
    guidance over a respaced DDPM, f32, B=2: the guidance gradient runs through
    the kernel's autograd Function (the kernel forward, the plain version's
    recompute backward) on the card, then the same run with the kernel swapped
    for its plain version. In float mode the two paths differ by the kernel's
    rounding (tolerance DDIM_TOL). In int8_static they take the same float
    operations on the same values: the int8 sums are exact, and the recompute
    gives x a gradient of exactly zero through the codes, as JAX's autodiff
    does; so they must agree bit for bit."""
    from condmdi_tpu_torch.sampling.pipeline import build_inpainting_state

    B, steps = 2, GUIDANCE_STEPS
    float_mode = precision_mode == "float"
    model = build_xl(dev, torch.float32, precision_mode=precision_mode)
    if not float_mode:
        calibrate_on_q_sample(model, B, dev, 33)
    pipe = pipeline(model, schedule(steps), dev)
    text, obs, mask = (a.to(dev) for a in keyframe_inputs(B, 4))
    inpaint = build_inpainting_state(obs, mask, imputate=True, reconstruction_guidance=True,
                                     reconstruction_weight=GUIDANCE_WEIGHT, diffusion_steps=steps)
    noise = seeded_noise((B, T_FRAMES, FEATS), dev, seed=8)
    outs = []

    def run():
        gen = torch.Generator(device=dev).manual_seed(5)
        outs.append(pipe.sample((B, T_FRAMES, FEATS), {"text_embed": text}, obs_x0=obs,
                                obs_mask=mask, inpaint=inpaint, noise=noise, generator=gen))
        return outs[-1]

    kernel, per_step = ("fused_conv_gn_mish", 33) if float_mode else ("int8_conv1d", 41)
    reset_counts()
    err = kernel_vs_plain("recguidance", f"UNet-XL {precision_mode} f32 DDPM-{steps}, imputation "
                          f"and reconstruction guidance (weight {GUIDANCE_WEIGHT}), B={B}", run,
                          resblock_swapped_for_plain if float_mode else int8_swapped_for_plain)
    launches = read_counts()[kernel]
    kept = (outs[0][mask] - obs[mask]).abs().max().item()
    print(f"[recguidance] UNet-XL {precision_mode}: {kernel} launches {launches} (expected "
          f"{per_step} x {steps} in the kernel run); max|sample - keyframe| on the keyframes "
          f"{kept:.3e}", flush=True)
    if launches != per_step * steps:
        raise SystemExit(f"UNet-XL recguidance {kernel} launches {launches} != {per_step * steps}")
    if kept > 1e-6:
        raise SystemExit("imputation did not keep the keyframes")
    if not float_mode and err != 0.0:
        raise SystemExit(f"UNet-XL {precision_mode} recguidance: kernel path and plain path differ "
                         f"by {err:.3e}, where they take the same operations")
    return err


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


# --------------------------------------------------------------------------- #
# phases 15-17: the sampling and editing CLIs on the card, through their `main`
# --------------------------------------------------------------------------- #
CLI_OUT = ROOT / "chiprun_out" / "cli"
GATE_CKPT = str(ROOT / "save" / "synthetic_unet_m" / "gate_ema_000100000.npz")
GATE_HALVES = 25  # resblock halves of one forward of the gate UNet (latent 128, dim_mults 1 2 2)
CLI_SAMPLES, CLI_STEPS = 4, 1000  # the gate and MDM runs; the full DDPM, CFG at the default 2.5
XL_CLI_SAMPLES = 2
# the reconstruction-guidance run (eager: a gradient through the UNet every step) samples
# 250 respaced steps of the 1000-step schedule (it took 42-60 s at 1000)
RECG_CLI_STEPS = 250
# UNet-XL at full width and depth with Flax's initialisation from --seed; unet_zero off, or
# the zero-initialised output convs would make every sample exactly 0
XL_CLI = ["--arch", "unet", "--latent_dim", "512", "--dim_mults", "2", "2", "2", "2",
          "--num_frames", "196", "--unet_pad_to", "224", "--unet_zero", "false",
          "--edit_mode", "benchmark_sparse", "--num_samples", str(XL_CLI_SAMPLES),
          "--num_repetitions", "1"]
GATE_CLI = ["--model_path", GATE_CKPT, "--edit_mode", "benchmark_sparse",
            "--num_samples", str(CLI_SAMPLES), "--num_repetitions", "1"]
MDM_CLI = ["--num_samples", str(CLI_SAMPLES), "--num_repetitions", "1"]  # trans_enc defaults
DDIM20 = ["--use_ddim", "true", "--timestep_respacing", "ddim20"]
# the results.npy keys of the JAX CLIs (condmdi_tpu/sampling/conditional.py:143-156,
# edit.py:113-126, synthesize.py:143-155)
CLI_KEYS = {
    "conditional": {"motion", "joints", "text", "lengths", "observed_motion", "observed_mask",
                    "edit_mode", "text_encoder"},
    "edit": {"motion", "joints", "text", "lengths", "inpainted_motion", "inpainting_mask",
             "edit_mode", "text_encoder"},
    "synthesize": {"motion", "joints", "text", "lengths", "num_samples", "num_repetitions",
                   "text_encoder"},
}


def run_cli(cli, argv, label):
    """One CLI `main` on the card, the counts set to 0 just before it and read just
    after; np.random seeded first (the dataset draws its crops and captions from
    it). Returns (results.npy, host seconds, launches)."""
    import importlib

    main = importlib.import_module(f"condmdi_tpu_torch.sampling.{cli}").main
    out = CLI_OUT / label
    np.random.seed(0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    main(argv + ["--output_dir", str(out)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    return np.load(out / "results.npy", allow_pickle=True).item(), seconds, launches


def check_cli_result(cli, res, label, B, T=T_FRAMES):
    if set(res) != CLI_KEYS[cli]:
        raise SystemExit(f"{label}: results.npy keys {sorted(res)} are not the JAX CLI's "
                         f"{sorted(CLI_KEYS[cli])}")
    for key, shape in (("motion", (B, T, FEATS)), ("joints", (B, T, 22, 3))):
        a = res[key]
        if a.shape != shape or not np.isfinite(a).all() or float(a.std()) == 0.0:
            raise SystemExit(f"{label}: {key} has shape {a.shape} (expected {shape}), finite "
                             f"{bool(np.isfinite(a).all())}, std {float(a.std())}")


def keyframe_joint_error(res, abs_3d):
    """Mean distance (m) between the sample's joints and the observed motion's
    joints over the observed frames, and max |motion - observed| on the observed
    features."""
    from condmdi_tpu_torch.data.dataset import DatasetConfig, SyntheticMotionDataset
    from condmdi_tpu_torch.data.humanml_repr import recover_from_ric

    obs, mask = res["observed_motion"], res["observed_mask"]
    stats = SyntheticMotionDataset._population_stats(DatasetConfig(abs_3d=abs_3d))
    obs_joints = recover_from_ric(torch.from_numpy(obs * stats.std + stats.mean), 22,
                                  abs_3d=abs_3d).numpy()
    frames = mask.any(axis=-1)
    dist = np.linalg.norm(res["joints"] - obs_joints, axis=-1)[frames]
    return float(dist.mean()), float(np.abs(res["motion"][mask] - obs[mask]).max())


def cli_conditional(label, argv, B, abs_3d, expect, imputate=False):
    res, seconds, launches = run_cli("conditional", argv, label)
    check_cli_result("conditional", res, label, B)
    if not res["observed_mask"].any():
        raise SystemExit(f"{label}: the observation mask is empty")
    kf_err, kept = keyframe_joint_error(res, abs_3d)
    print(f"[cli] conditional {label}: {seconds:.2f} s on the host, {B / seconds:.4f} samples/s; "
          f"keyframe joint error {kf_err:.4f} m, max|motion - observed| on the observed "
          f"features {kept:.3e}; launches {launches} (expected {expect})", flush=True)
    if imputate and kept != 0.0:
        raise SystemExit(f"{label}: imputation did not keep the observed features exactly")
    for kern, count in expect.items():
        if launches[kern] != count:
            raise SystemExit(f"{label}: {kern} launches {launches[kern]} != {count}")
    return dict(seconds=seconds, samples_per_s=B / seconds, keyframe_joint_error_m=kf_err,
                observed_max_abs_diff=kept, launches=launches)


def cli_phase15(card):
    """conditional through its main: the gate checkpoint plain, with imputation
    and with reconstruction guidance (its default weight 5), then UNet-XL at
    full width with no checkpoint, float and int8."""
    runs = {}
    recg = ["--reconstruction_guidance", "true", "--timestep_respacing", str(RECG_CLI_STEPS)]
    for name, extra, imp, steps in (("gate", [], False, CLI_STEPS),
                                    ("gate_imputate", ["--imputate", "true"], True, CLI_STEPS),
                                    ("gate_recguidance", recg, False, RECG_CLI_STEPS)):
        gate = dict(fused_conv_gn_mish=GATE_HALVES * steps, fused_self_attention=0, int8_conv1d=0)
        runs[name] = cli_conditional(name, GATE_CLI + extra, CLI_SAMPLES, True, gate, imp)
    xl = dict(fused_conv_gn_mish=33 * CLI_STEPS, fused_self_attention=0, int8_conv1d=0)
    runs["xl_f32"] = cli_conditional("xl_f32", XL_CLI, XL_CLI_SAMPLES, False, xl)
    xl8 = dict(fused_conv_gn_mish=0, fused_self_attention=0, int8_conv1d=41 * CLI_STEPS)
    runs["xl_int8"] = cli_conditional("xl_int8", XL_CLI + ["--precision_mode", "int8"],
                                      XL_CLI_SAMPLES, False, xl8)
    print(f"[cli] {card}: conditional, {CLI_STEPS}-step DDPM, CFG 2.5, f32: "
          + ", ".join(f"{k} {v['samples_per_s']:.4f} samples/s" for k, v in runs.items()),
          flush=True)
    return runs


def cli_phase16(card):
    """edit and synthesize through their main on MDM at the default widths."""
    runs = {}
    res, seconds, launches = run_cli(
        "edit", MDM_CLI + ["--edit_mode", "benchmark_clip", "--imputate", "true"], "edit")
    check_cli_result("edit", res, "edit", CLI_SAMPLES)
    mask = res["inpainting_mask"]
    kept = float(np.abs(res["motion"][mask] - res["inpainted_motion"][mask]).max())
    runs["edit"] = dict(seconds=seconds, samples_per_s=CLI_SAMPLES / seconds, launches=launches,
                        observed_max_abs_diff=kept)
    res, seconds, launches_s = run_cli(
        "synthesize", MDM_CLI + ["--text_prompt", "a person walks forward and waves",
                                 "--motion_length", "9.8"], "synthesize")
    check_cli_result("synthesize", res, "synthesize", CLI_SAMPLES)
    runs["synthesize"] = dict(seconds=seconds, samples_per_s=CLI_SAMPLES / seconds,
                              launches=launches_s)
    for name, run in runs.items():
        print(f"[cli] {card}: {name} MDM trans_enc f32, {CLI_STEPS}-step DDPM: "
              f"{run['seconds']:.2f} s on the host, {run['samples_per_s']:.4f} samples/s; "
              f"launches {run['launches']} (expected fused_self_attention {8 * CLI_STEPS})",
              flush=True)
        if run["launches"]["fused_self_attention"] != 8 * CLI_STEPS:
            raise SystemExit(f"{name}: attention launches != {8 * CLI_STEPS}")
    if not mask.any() or kept != 0.0:
        raise SystemExit(f"edit: imputation did not keep the observed features ({kept:.3e})")
    return runs


def cli_kernel_vs_plain(cli, argv, label, kernel, per_step, swap):
    """One CLI run through the kernel and one with `swap` in place, same seed, so
    the same x_T; max |kernel - plain| of the motions within DDIM_TOL."""
    got, t_kernel, launches = run_cli(cli, argv, label + "_kernel")
    with swap():
        want, t_plain, plain_launches = run_cli(cli, argv, label + "_plain")
    err = float(np.abs(got["motion"] - want["motion"]).max())
    print(f"[cli] {label}: max|kernel - plain| = {err:.3e} (tol {DDIM_TOL:.0e}), max|plain| = "
          f"{float(np.abs(want['motion']).max()):.3f}; kernel run {t_kernel:.2f} s, plain run "
          f"{t_plain:.2f} s; {kernel} launches {launches[kernel]} (expected {per_step} x 20), "
          f"{plain_launches[kernel]} in the plain run", flush=True)
    if not (np.isfinite(got["motion"]).all() and err <= DDIM_TOL
            and np.abs(want["motion"]).max() > 0):
        raise SystemExit(f"{label}: the kernel path disagrees with the plain path")
    if launches[kernel] != per_step * 20 or plain_launches[kernel] != 0:
        raise SystemExit(f"{label}: {kernel} launches {launches[kernel]} / {plain_launches[kernel]}")
    return err


def cli_model(argv, dev):
    """conditional's model for `argv`, built as its main builds it."""
    from condmdi_tpu_torch.sampling.conditional import parse_cli_args
    from condmdi_tpu_torch.sampling.synthesize import load_model_for_sampling

    return load_model_for_sampling(parse_cli_args(argv), dev)[0]


def cli_resblock_shapes(argv, B, dev):
    """(the CLI's UNet, its resblock shapes at batch B, one forward's inputs)."""
    model = cli_model(argv, dev)
    text, obs, mask = (a.to(dev) for a in keyframe_inputs(B, 21))
    x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=22)
    t = torch.full((B,), 500, device=dev)
    y = {"text_embed": text}
    kw = dict(obs_x0=obs, obs_mask=mask)
    return model, record_resblock_shapes(model, x, t, y, kw), (x, t, y, kw)


def f32_resblock_shapes(name, argv, B, dev, step_wall_ms):
    """Every f32 resblock shape of the CLI's UNet at its batch B, per call and
    timed (f32_resblock_rows); one forward on the host clock against its device
    time, and its kernels by time."""
    model, shapes, (x, t, y, kw) = cli_resblock_shapes(argv, B, dev)
    out = f32_resblock_rows(name, shapes, B, dev)

    def call():
        return model(x, t, y, **kw)

    forward = forward_host_vs_device(f"{name} f32 forward at B={B}", call, step_wall_ms)
    forward["profile"] = profile_forward(f"{name} f32 forward at B={B}", call)
    return dict(out, forward=forward)


CLI_ATTENTION = [("edit", CLI_SAMPLES, MDM_TOKENS, 512, 4),  # B = samples
                 ("synthesize", 2 * CLI_SAMPLES, MDM_TOKENS, 512, 4)]  # 2 x samples under CFG


def int8_model_rows(model, B, dev, card, label, form, expect=None, step_wall_ms=None):
    """Every int8 conv shape of `model`'s forward at batch B (f32 activations, the
    activation scale in `form`): the kernel against plain per call, with the tiles
    and split of the K steps each launch takes and its times; with `step_wall_ms`,
    one forward on the host clock against its device time, and its kernels by time."""
    text, obs, mask = (a.to(dev) for a in keyframe_inputs(B, 21))
    x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=22)
    t = torch.full((B,), 500, device=dev)
    y = {"text_embed": text}
    shapes = record_int8_shapes(model, x, t, y, dict(obs_x0=obs, obs_mask=mask))
    if expect is not None and sum(shapes.values()) != expect:
        raise SystemExit(f"expected {expect} int8 convs per {label} forward, found {shapes}")
    gen = torch.Generator(device=dev).manual_seed(24)
    rows = []
    for (cin, cout, k, stride, pad, T, xc), count in sorted(shapes.items()):
        xq, q = int8_inputs(B, T, cin, cout, k, form, torch.float32, gen, dev, xc)
        err, exact = int8_kernel_against_plain(
            f"{label} f32 {form} x[{B},{T},{xc}] Cin={cin} Cout={cout} k={k} s={stride}",
            xq, q, stride, pad)
        plan = int8_plan(B, T, cin, cout, k, stride, pad, dev)
        row = dict(cin=cin, cout=cout, k=k, stride=stride, padding=pad, T=T, x_channels=xc,
                   B=B, per_forward=count, max_abs_err_f32=err, bit_exact=exact, plan=plan)
        row.update(time_int8(B, T, cin, cout, k, stride, pad, xc, form, gen, dev,
                             cudnn=False, dtype=torch.float32))
        t_out = (T + 2 * pad - k) // stride + 1
        row["bound_ms"], row["bound_by"] = int8_bound_ms(B, T, t_out, cin, cout, k, itemsize=4)
        print(f"[{label} int8] B={B} Cin={cin} Cout={cout} k={k} s={stride} T={T} x{count}: "
              f"{plan_text(plan)}; f32 {form}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), host enqueue {row['host_ms']:.4f} ms",
              flush=True)
        rows.append(row)
    out = dict(rows=rows, convs=sum(shapes.values()))
    if step_wall_ms is not None:
        def call():
            return model(x, t, y, obs_x0=obs, obs_mask=mask)

        out["forward"] = forward_host_vs_device(f"{label} int8 f32 forward at B={B}", call,
                                                step_wall_ms)
        out["forward"]["profile"] = profile_forward(f"{label} int8 f32 forward at B={B}", call)
    out.update({k: sum(r[k] * r["per_forward"] for r in rows)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    print(f"[{label} int8] {card}: the {out['convs']} int8 convs of one forward at B={B} within "
          f"{max(r['max_abs_err_f32'] for r in rows):.3e} of plain, bit-exact "
          f"{all(r['bit_exact'] for r in rows)}; kernel {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, library {out['library_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms", flush=True)
    return out


def cli_phase17(dev, card, runs15):
    """Kernel against plain through the CLIs (UNet-XL conditional in float and in
    int8, MDM edit; DDIM-20), then every new f32 kernel shape per call, with
    times, and every int8 conv shape of the XL int8 CLI per call."""
    out = dict(
        xl_ddim_err=cli_kernel_vs_plain("conditional", XL_CLI + DDIM20, "xl_ddim20",
                                        "fused_conv_gn_mish", 33, resblock_swapped_for_plain),
        edit_ddim_err=cli_kernel_vs_plain(
            "edit", MDM_CLI + ["--edit_mode", "benchmark_clip", "--imputate", "true"] + DDIM20,
            "edit_ddim20", "fused_self_attention", 8, attention_swapped_for_plain),
        xl_int8_ddim_err=cli_kernel_vs_plain(
            "conditional", XL_CLI + ["--precision_mode", "int8"] + DDIM20, "xl_int8_ddim20",
            "int8_conv1d", 41, int8_swapped_for_plain))
    out["gate"] = f32_resblock_shapes("gate UNet", GATE_CLI, 2 * CLI_SAMPLES, dev,
                                      runs15["gate"]["seconds"] * 1e3 / CLI_STEPS)
    out["xl"] = f32_resblock_shapes("UNet-XL pad 224", XL_CLI, 2 * XL_CLI_SAMPLES, dev,
                                    runs15["xl_f32"]["seconds"] * 1e3 / CLI_STEPS)
    if out["gate"]["halves"] != GATE_HALVES or out["xl"]["halves"] != 33:
        raise SystemExit("unexpected resblock halves per forward in the CLI models")
    out["attention"] = f32_attention_rows(dev, CLI_ATTENTION)
    out["int8"] = int8_model_rows(
        cli_model(XL_CLI + ["--precision_mode", "int8"], dev), 2 * XL_CLI_SAMPLES, dev, card,
        "cli", "dynamic", expect=41, step_wall_ms=runs15["xl_int8"]["seconds"] * 1e3 / CLI_STEPS)
    return out


# --------------------------------------------------------------------------- #
# phases 18-20: the evaluation protocols on the card, through their `main`
# --------------------------------------------------------------------------- #
EVAL_OUT = ROOT / "chiprun_out" / "eval"  # never the default: it holds committed JAX reports
EVAL_BATCH, EVAL_BATCHES = 32, 2
GATE_FINGERPRINT = "0d69067e95b7d9da"  # the gate npz's __params_fingerprint__
EVAL_GATE = ["--model_path", GATE_CKPT, "--edit_mode", "benchmark_sparse",
             "--transition_length", "10", "--guidance_param", "1.0", "--seed", "10",
             "--text_encoder", "hash", "--eval_mode", "debug", "--max_replications", "1",
             "--num_samples", str(EVAL_BATCH * EVAL_BATCHES)]
# the keyframe mask's settings, as the report's meta must record them
EVAL_MASK = dict(transition_length=10, n_keyframes=5, editable_features="pos_rot_vel")
EVAL_INT8 = ["--precision_mode", "int8_static", "--int8_float_last_k", str(K_FLOAT)]
# MDM at the default widths with Flax's initialisation from --seed, text only, CFG 2.5
EVAL_T2M = ["--eval_mode", "debug", "--max_replications", "1", "--num_samples", str(EVAL_BATCH),
            "--guidance_param", "2.5", "--text_encoder", "hash", "--seed", "10"]
# the report keys of the JAX CLIs (condmdi_tpu/evals/harness.py evaluation, run.py meta)
EVAL_METRICS = {"matching_score", "r_precision", "fid", "diversity", "skating_ratio"}
KEYFRAME_METRICS = {"traj_error", "keyframe_error"}


def run_eval(module, argv, label):
    """One evaluation CLI `main` on the card (condmdi_tpu_torch.evals.<module>), from
    the repository root (the committed evaluator is found relative to it), the
    counts set to 0 just before it and read just after. A trajectory calibration
    inside it is timed and counted apart, the counts set to 0 again after it. Returns
    the summary, the report, host seconds, launches, the calibration's seconds and
    launches, every GeneratedBatch, and each batch's sampler output and its joints
    (`outputs`: what the harness hands sample_to_motion first, and gets back)."""
    import importlib

    import condmdi_tpu_torch.evals.harness as harness
    import condmdi_tpu_torch.evals.run as run_mod

    main = importlib.import_module(f"condmdi_tpu_torch.evals.{module}").main
    out = EVAL_OUT / label
    batches, outputs, converted, calib = [], [], [], {}
    real_generate, real_calibrate = harness.generate_eval_batch, run_mod.calibrate
    real_to_motion = harness.sample_to_motion

    def to_motion(sample, stats):
        converted.append((sample, real_to_motion(sample, stats)))
        return converted[-1][1]

    def generate(*a, **kw):
        converted.clear()
        batches.append(real_generate(*a, **kw))
        (sample, joints), _ground_truth = converted  # the generated motions come first
        outputs.append(dict(sample=sample.cpu().numpy(), joints=joints.cpu().numpy()))
        return batches[-1]

    def calibrate(*a, **kw):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        real_calibrate(*a, **kw)
        torch.cuda.synchronize()
        calib.update(seconds=time.perf_counter() - t0, launches=read_counts())
        reset_counts()

    harness.generate_eval_batch, run_mod.calibrate = generate, calibrate
    harness.sample_to_motion = to_motion
    try:
        with contextlib.chdir(ROOT):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            summary = main(argv + ["--output_dir", str(out)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counts()
    finally:
        harness.generate_eval_batch, run_mod.calibrate = real_generate, real_calibrate
        harness.sample_to_motion = real_to_motion
    (path,) = out.glob("eval_*.json")
    return dict(summary=summary, report=json.loads(path.read_text()), report_name=path.name,
                seconds=seconds, launches=launches, calibration=calib or None, batches=batches,
                outputs=outputs)


def check_eval_report(run, label, keyframes=True):
    """The report holds the JAX report's keys (the metrics, per_replication, meta), every
    number finite; the generated motions finite, [32, 196, 263]."""
    rep = run["report"]
    metrics = EVAL_METRICS | (KEYFRAME_METRICS if keyframes else set())
    if set(rep) != metrics | {"per_replication", "meta"} or set(rep["per_replication"]) != metrics:
        raise SystemExit(f"{label}: report keys {sorted(rep)} are not the JAX report's")
    values = [np.asarray(rep[k]["mean"]) for k in metrics] + \
        [np.asarray(rep["per_replication"][k]) for k in metrics]
    if not all(np.isfinite(v).all() for v in values):
        raise SystemExit(f"{label}: non-finite metrics in the report")
    for gb in run["batches"]:
        if gb.motions_rel.shape != (EVAL_BATCH, T_FRAMES, FEATS) or \
                not np.isfinite(gb.motions_rel).all():
            raise SystemExit(f"{label}: generated motions {gb.motions_rel.shape} not finite "
                             f"[{EVAL_BATCH}, {T_FRAMES}, {FEATS}]")
    return {k: rep[k]["mean"] for k in sorted(metrics)}


def eval_line(label, run, card, expect):
    n = EVAL_BATCH * len(run["batches"])
    metrics = {k: v for k, v in run["summary"].items() if isinstance(v, dict)}
    print(f"[eval] {card}: {label}: {run['seconds']:.2f} s on the host for {n} samples, "
          f"{n / run['seconds']:.4f} samples/s; launches {run['launches']} (expected {expect})"
          + (f"; calibration {run['calibration']['seconds']:.2f} s, launches "
             f"{run['calibration']['launches']}" if run["calibration"] else "")
          + "; " + ", ".join(f"{k} {np.round(v['mean'], 4).tolist()}" for k, v in metrics.items()),
          flush=True)
    for kern, count in expect.items():
        if run["launches"][kern] != count:
            raise SystemExit(f"{label}: {kern} launches {run['launches'][kern]} != {count}")


def eval_phase18(dev, card):
    """evals.run through its main on the gate checkpoint: float, then int8_static with
    the float tail (k_float 250); one B=32 forward's host time against device time."""
    out = {}
    float_run = run_eval("run", EVAL_GATE, "gate_float")
    out["float_metrics"] = check_eval_report(float_run, "gate float")
    fingerprint = float_run["report"]["meta"]["params_fingerprint"]
    if fingerprint != GATE_FINGERPRINT or float_run["summary"]["params_fingerprint"] != fingerprint:
        raise SystemExit(f"gate report fingerprint {fingerprint} != {GATE_FINGERPRINT}")
    eval_line("evals.run gate float, 1000-step DDPM, f32", float_run, card,
              dict(fused_conv_gn_mish=GATE_HALVES * CLI_STEPS * EVAL_BATCHES,
                   fused_self_attention=0, int8_conv1d=0))
    out["float"] = {k: float_run[k] for k in ("seconds", "launches", "report_name")}
    out["float"]["samples_per_s"] = EVAL_BATCH * EVAL_BATCHES / float_run["seconds"]
    out["fingerprint"] = fingerprint
    mask = {k: float_run["report"]["meta"][k] for k in EVAL_MASK}
    if mask != EVAL_MASK:
        raise SystemExit(f"gate report's mask settings {mask} are not the run's {EVAL_MASK}")

    model, shapes, (x, t, y, kw) = cli_resblock_shapes(GATE_CLI, EVAL_BATCH, dev)
    if sum(shapes.values()) != GATE_HALVES:
        raise SystemExit(f"expected {GATE_HALVES} resblock halves per gate forward, found {shapes}")

    def call():
        return model(x, t, y, **kw)

    step_ms = float_run["seconds"] * 1e3 / (CLI_STEPS * EVAL_BATCHES)
    out["forward"] = forward_host_vs_device(f"gate UNet f32 forward at B={EVAL_BATCH}", call,
                                            step_ms)
    out["forward"]["profile"] = profile_forward(f"gate UNet f32 forward at B={EVAL_BATCH}", call)
    del model

    int8_model = cli_model(GATE_CLI + ["--precision_mode", "int8_static"], dev)
    text, obs, mask = (a.to(dev) for a in keyframe_inputs(EVAL_BATCH, 21))
    convs = sum(record_int8_shapes(
        int8_model, seeded_noise((EVAL_BATCH, T_FRAMES, FEATS), dev, seed=22),
        torch.full((EVAL_BATCH,), 500, device=dev), {"text_embed": text},
        dict(obs_x0=obs, obs_mask=mask)).values())
    del int8_model
    int8_run = run_eval("run", EVAL_GATE + EVAL_INT8, "gate_int8_f250")
    out["int8_metrics"] = check_eval_report(int8_run, "gate int8_static f250")
    n_float = int((schedule(CLI_STEPS).timestep_map < K_FLOAT).sum())
    calib_expect = dict(fused_conv_gn_mish=0, fused_self_attention=0, int8_conv1d=convs * CLI_STEPS)
    if int8_run["calibration"]["launches"] != calib_expect:
        raise SystemExit(f"calibration launches {int8_run['calibration']['launches']} != "
                         f"{calib_expect}")
    eval_line(f"evals.run gate int8_static + float tail (k_float={K_FLOAT}), 1000-step DDPM, f32 "
              f"({convs} int8 convs a forward)", int8_run, card,
              dict(fused_conv_gn_mish=GATE_HALVES * n_float * EVAL_BATCHES, fused_self_attention=0,
                   int8_conv1d=convs * (CLI_STEPS - n_float) * EVAL_BATCHES))
    out["int8"] = {k: int8_run[k] for k in ("seconds", "launches", "report_name", "calibration")}
    out["int8"]["samples_per_s"] = EVAL_BATCH * EVAL_BATCHES / int8_run["seconds"]
    out["int8"]["convs_per_forward"] = convs
    print(f"[eval] {card}: gate float against int8_static f{K_FLOAT} on the same seeds: "
          + ", ".join(f"{k} {np.round(out['float_metrics'][k], 4).tolist()} / "
                      f"{np.round(out['int8_metrics'][k], 4).tolist()}"
                      for k in out["float_metrics"]), flush=True)
    return out


def eval_phase19(dev, card):
    """evals.run_t2m through its main on MDM at the default widths (Flax's
    initialisation), CFG 2.5: B=64 forwards, 8 attention launches each."""
    run = run_eval("run_t2m", EVAL_T2M, "t2m")
    metrics = check_eval_report(run, "t2m", keyframes=False)
    if KEYFRAME_METRICS & set(run["summary"]):
        raise SystemExit("evals.run_t2m reported keyframe metrics")
    eval_line("evals.run_t2m MDM trans_enc, 1000-step DDPM, CFG 2.5, f32", run, card,
              dict(fused_conv_gn_mish=0, fused_self_attention=8 * CLI_STEPS, int8_conv1d=0))
    out = {k: run[k] for k in ("seconds", "launches", "report_name")}
    out.update(metrics=metrics, samples_per_s=EVAL_BATCH / run["seconds"])
    model = build_mdm(dev, torch.float32)
    x = seeded_noise((2 * EVAL_BATCH, T_FRAMES, FEATS), dev, seed=25)
    t = torch.full((2 * EVAL_BATCH,), 500, device=dev)
    y = {"text_embed": torch.randn((2 * EVAL_BATCH, 512), device=dev),
         "uncond": torch.arange(2 * EVAL_BATCH, device=dev) >= EVAL_BATCH}

    def call():
        return model(x, t, y)

    out["forward"] = forward_host_vs_device(f"MDM f32 forward at B={2 * EVAL_BATCH}", call,
                                            run["seconds"] * 1e3 / CLI_STEPS)
    out["forward"]["profile"] = profile_forward(f"MDM f32 forward at B={2 * EVAL_BATCH}", call)
    return out


def eval_kernel_vs_plain(argv, label, kernel, per_step, swap, card):
    """evals.run at DDIM-20 through the kernel and with `swap` in place, the same
    seed (so the same x_T per batch): the generated motions (the sampler's output)
    and their joints within DDIM_TOL. motions_rel, the same motions converted to
    the evaluator's relative features by inverse kinematics, magnifies those
    differences unevenly (ill-conditioned joint rotations; foot contacts that
    are thresholds, one flip moving a normalized value by ~2), so it is held as
    the CPU test holds it against JAX: mean |diff| / mean |plain| within
    REL_MEAN_TOL and at most REL_SHARE_TOL of the entries beyond
    1e-3·(1 + |plain|). The metrics of both paths printed side by side."""
    got = run_eval("run", argv + DDIM20, label + "_kernel")
    with swap():
        want = run_eval("run", argv + DDIM20, label + "_plain")
    stack = {key: (np.stack([o[key] for o in got["outputs"]]).astype(np.float64),
                   np.stack([o[key] for o in want["outputs"]]).astype(np.float64))
             for key in ("sample", "joints")}
    stack["motions_rel"] = tuple(np.stack([gb.motions_rel for gb in run["batches"]]).astype(
        np.float64) for run in (got, want))
    errs = {key: float(np.abs(a - b).max()) for key, (a, b) in stack.items()}
    for key in ("sample", "joints"):
        a, b = stack[key]
        if not (np.isfinite(a).all() and errs[key] <= DDIM_TOL and np.abs(b).max() > 0):
            raise SystemExit(f"{label}: {key} of the kernel path disagree with the plain path "
                             f"({errs[key]:.3e})")
    a, b = stack["motions_rel"]
    d = np.abs(a - b)
    rel_mean = float(d.mean() / np.abs(b).mean())
    share = float(np.mean(d > 1e-3 * (1 + np.abs(b))))
    if not (np.isfinite(a).all() and rel_mean <= REL_MEAN_TOL and share <= REL_SHARE_TOL):
        raise SystemExit(f"{label}: motions_rel of the kernel path disagree with the plain path "
                         f"(mean-relative {rel_mean:.2e}, share beyond 1e-3 {share:.2e})")
    n = per_step * 20 * EVAL_BATCHES
    if got["launches"][kernel] != n or want["launches"][kernel] != 0:
        raise SystemExit(f"{label}: {kernel} launches {got['launches'][kernel]} / "
                         f"{want['launches'][kernel]} (expected {n} / 0)")
    side = {k: (np.asarray(got["summary"][k]["mean"]).tolist(),
                np.asarray(want["summary"][k]["mean"]).tolist())
            for k in got["summary"] if isinstance(got["summary"][k], dict)}
    equal = all(np.array_equal(x, y) for x, y in side.values())
    print(f"[eval] {card}: {label} DDIM-20 kernel against plain: max|Δ| motions "
          f"{errs['sample']:.3e}, joints {errs['joints']:.3e} (tol {DDIM_TOL:.0e}); motions_rel "
          f"max|Δ| {errs['motions_rel']:.3e}, mean-relative {rel_mean:.2e} (tol "
          f"{REL_MEAN_TOL:.0e}), share beyond 1e-3·(1+|plain|) {share:.2e} (tol "
          f"{REL_SHARE_TOL:.0e}); {kernel} launches {got['launches'][kernel]} / 0; metrics equal "
          f"{equal}; kernel / plain: "
          + ", ".join(f"{k} {np.round(x, 5).tolist()} / {np.round(y, 5).tolist()}"
                      for k, (x, y) in side.items()), flush=True)
    return dict(max_abs_err=errs, motions_rel_mean_rel=rel_mean, motions_rel_share=share,
                metrics=side, metrics_equal=equal, seconds=(got["seconds"], want["seconds"]))


def eval_phase20(dev, card):
    """Kernel against plain through evals.run (float and int8_static at DDIM-20), then
    each kernel per call at every new evaluation shape: the gate's f32 resblock halves
    at B=32, f32 attention at B=64 (CFG-doubled t2m), the gate's int8 convs (f32
    activations, static scale) at B=32."""
    out = dict(
        float=eval_kernel_vs_plain(EVAL_GATE, "gate_float", "fused_conv_gn_mish", GATE_HALVES,
                                   resblock_swapped_for_plain, card))
    out["int8_rows"] = int8_model_rows(cli_model(GATE_CLI + ["--precision_mode", "int8_static"],
                                                 dev), EVAL_BATCH, dev, card, "eval", "static")
    out["int8"] = eval_kernel_vs_plain(EVAL_GATE + ["--precision_mode", "int8_static"],
                                       "gate_int8_static", "int8_conv1d", out["int8_rows"]["convs"],
                                       int8_swapped_for_plain, card)
    _, shapes, _ = cli_resblock_shapes(GATE_CLI, EVAL_BATCH, dev)
    out["resblock_rows"] = f32_resblock_rows("gate UNet B=32", shapes, EVAL_BATCH, dev)
    out["attention_rows"] = f32_attention_rows(
        dev, [("t2m_eval", 2 * EVAL_BATCH, MDM_TOKENS, 512, 4)])
    return out


# --------------------------------------------------------------------------- #
# phases 21-23: training through training.train.main
# --------------------------------------------------------------------------- #
TRAIN_OUT = ROOT / "chiprun_out" / "train"
TRAIN_DATA = ["--data_dir", str(ROOT / "chiprun_out" / "no_humanml3d"), "--text_encoder", "hash",
              "--device_data_cache", "true", "--device_cache_refresh", "0", "--seed", "10",
              "--log_interval", "1"]
XL_TRAIN = ["--config", "motion_abs_unet_adagn_xl", "--keyframe_conditioned", "true",
            "--batch_size", "64", "--num_steps", "30", "--save_interval", "20"] + TRAIN_DATA
MDM_TRAIN = ["--config", "motion_mdm", "--batch_size", "64", "--num_steps", "20",
             "--save_interval", "20"] + TRAIN_DATA
XL_TRAIN_HALVES, MDM_TRAIN_ATTENTIONS = 33, 8  # kernel launches per step
TRAIN_SAMPLE_STEPS = 20  # the DDIM-20 sample of the step-30 EMA (one CFG forward a step)
TRAIN_LOSS_TOL = 1e-4  # |kernel - plain| <= tol * (1 + |plain|) for one step's loss
# Phase 23 holds each parameter tensor on its own: its gradient by |g_kernel - g_plain| /
# |g_plain| and its update by |p_kernel - p_plain| / |p_plain - p_start| (norms over the
# tensor), the update taken from the training run's warmed AdamW state. Two classes:
# the float32 leaves; and with use_fp16 the leaves whose gradient passes a bfloat16 cast
# (BF16_GRAD_LEAVES: QConv rounds the first block's residual-conv and first-half kernel and
# bias to bfloat16, and the cast's backward rounds their gradient), where one float32
# difference can move a gradient element by a bfloat16 ulp. The limits come from readings
# on an NVIDIA H100 80GB HBM3 at 700 W. Gradients: float32 tensors at most 2.2e-05
# (UNet-XL) and 3.7e-06 (MDM), limit 1e-4; the bfloat16 ones 8.0e-04, limit 4e-3, about
# one bfloat16 ulp. Updates: float32 tensors at most 3.0e-04, limit 1e-3, since the float32
# rounding of p - u for |p| near 1 (a norm scale) is 6e-8, 6e-4 of an lr-sized update; the
# bfloat16 ones 6.1e-04, limit 4e-3. MDM's attention key biases, whose gradient is rounding
# noise, by their largest |p_kernel - p_plain|: 9.1e-09, limit 1e-2 lr.
TRAIN_GRAD_TOL, TRAIN_GRAD_BF16_TOL = 1e-4, 4e-3
TRAIN_UPDATE_TOL, TRAIN_UPDATE_BF16_TOL = 1e-3, 4e-3
TRAIN_KEY_BIAS_TOL = 1e-2  # x lr
BF16_GRAD_LEAVES = ("unet.down0_res1.residual_conv.", "unet.down0_res1.block1.conv.")


def run_train(argv, save_dir, label, expect):
    """training.train.main on the card, counts set to 0 just before and read just
    after; the kernel's launches must be `expect`. Returns (loop, host s, launches)."""
    from condmdi_tpu_torch.training import train

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loop = train.main(argv + ["--save_dir", str(save_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    kernel, count = expect
    print(f"[train] {label}: {seconds:.2f} s on the host clock, {kernel} launches "
          f"{launches[kernel]} (expected {count})", flush=True)
    if launches[kernel] != count:
        raise SystemExit(f"{label}: {kernel} launched {launches[kernel]} times, not {count}")
    return loop, seconds, launches


def progress_rows(save_dir):
    import csv

    with open(Path(save_dir) / "progress.csv") as f:
        return [{k: float(v) for k, v in r.items() if k and v != ""} for r in csv.DictReader(f)]


def steps_per_second(rows, first, end=None):
    """Steps `first` to `end` (exclusive; all from `first` on by default) over
    their host wall time. Each row is one step (log_interval 1) and its rate is
    1 / the host time since the previous row, so the wall time is the sum of
    1 / rate, stalls included."""
    rates = [r["steps_per_sec"] for r in rows
             if r["step"] >= first and (end is None or r["step"] < end)]
    return len(rates) / sum(1.0 / r for r in rates)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms while open: with its defaults a conv's
    backward may sum in a different order from run to run (a resume then lands
    1.7e-6 from the straight run on an NVIDIA H100 80GB HBM3)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def drop_checkpoints(save_dir):
    """Delete a training run's checkpoints (UNet-XL's resume file is 3.2 GB),
    keeping args.json, log.txt and progress.csv."""
    for f in list(Path(save_dir).glob("ckpt_*.pth")) + list(Path(save_dir).glob("ema_*.npz")):
        f.unlink()


def same_checkpoint(a, b):
    """(bit for bit, max |a - b| over params and EMA) of two resume files."""
    from condmdi_tpu_torch.utils import checkpoint as ckpt

    sa, sb = ckpt.load_checkpoint(a), ckpt.load_checkpoint(b)
    pairs = [(sa["model"][k], sb["model"][k]) for k in sa["model"]]
    pairs += [(sa["train_state"]["ema"][k], sb["train_state"]["ema"][k])
              for k in sa["train_state"]["ema"]]
    exact = all(torch.equal(x, y) for x, y in pairs)
    return exact, max(float((x.float() - y.float()).abs().max()) for x, y in pairs)


def step_split(loop, label, card):
    """One train step of `loop`'s model on a batch from its device cache: the host
    clock against the device time, the device time split into the resblock
    kernel's forwards, the rest of the forward, the resblock halves' backward (the
    plain recompute and the gradient through it), the rest of the backward and the
    optimizer (clip, AdamW, EMA), by CUDA events (the eager step's device-timed
    spans, utils/tracing.py); and the step's kernels by time (torch.profiler).
    Launches made here are not the main path's."""
    import condmdi_tpu_torch.ops.resblock as rb
    from condmdi_tpu_torch.training.loop import make_train_step
    from condmdi_tpu_torch.utils import tracing

    data, n = loop.device_data
    batch = loop._gather(data, np.arange(loop.args.batch_size) % n)
    spans = {"kernel": [], "recompute": []}

    def timed(fn, key):
        def wrapper(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            spans[key].append((e0, e1))
            return out
        return wrapper

    step = make_train_step(loop.model, loop.sched, loop.dcfg, loop.tcfg, cuda_graphs=False)
    for _ in range(2):  # warm
        step(loop.state, batch, loop.draws)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(loop.state, batch, loop.draws)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launch, recompute = rb._launch, rb.recompute_grads
    rb._launch, rb.recompute_grads = timed(launch, "kernel"), timed(recompute, "recompute")
    try:
        step(loop.state, batch, loop.draws)
        torch.cuda.synchronize()
    finally:
        rb._launch, rb.recompute_grads = launch, recompute

    def part_ms(name):  # the last step's
        return tracing.spans(name)[-1].device_ms()

    split = {"forward_ms": part_ms("train.forward"), "backward_ms": part_ms("train.backward"),
             "optimizer_ms": part_ms("train.optimizer")}
    split["kernel_forward_ms"] = sum(a.elapsed_time(b) for a, b in spans["kernel"])
    split["recompute_backward_ms"] = sum(a.elapsed_time(b) for a, b in spans["recompute"])
    split["host_ms"] = statistics.median(walls)
    split["kernel_launches"] = len(spans["kernel"])
    prof = profile_forward(f"{label} train step", lambda: step(loop.state, batch, loop.draws),
                           top=10, iters=1, grad=True)
    split["device_ms"] = prof["total_ms"]
    split["profile"] = prof
    dev_ms = split["device_ms"]
    print(f"[train] {label} one step: {split['host_ms']:.2f} ms on the host clock, "
          + (f"{dev_ms:.2f} ms of device time (idle {1 - dev_ms / split['host_ms']:.1%})"
             if dev_ms else "device time not measured")
          + f"; forward {split['forward_ms']:.2f} ms (resblock kernel {split['kernel_forward_ms']:.2f}"
          f" ms in {split['kernel_launches']} launches), backward {split['backward_ms']:.2f} ms "
          f"(resblock halves' plain recompute and gradient {split['recompute_backward_ms']:.2f} ms),"
          f" optimizer {split['optimizer_ms']:.2f} ms [{card}]", flush=True)
    return split


def train_phase21(dev, card):
    """UNet-XL training through main: 30 steps, a resume from step 20 to 30 that
    must give the same step-30 parameters and EMA, the step-30 EMA sampled by
    conditional at DDIM-20, a run under cuDNN's defaults for steps/s and peak
    memory, one step's time split, and the kernel at the training shapes."""
    import shutil

    from condmdi_tpu_torch.sampling.conditional import parse_cli_args
    from condmdi_tpu_torch.sampling.synthesize import load_model_for_sampling
    from condmdi_tpu_torch.utils.checkpoint import params_fingerprint
    from condmdi_tpu_torch.weights import to_flax_params

    run_a, run_b, run_t = TRAIN_OUT / "xl", TRAIN_OUT / "xl_resumed", TRAIN_OUT / "xl_timed"
    for d in (run_a, run_b, run_t):
        shutil.rmtree(d, ignore_errors=True)
    with deterministic_cudnn():  # so that the resume below can be compared bit for bit
        loop, seconds, launches = run_train(XL_TRAIN, run_a, "UNet-XL 30 steps",
                                            ("fused_conv_gn_mish", 30 * XL_TRAIN_HALVES))
    rows = progress_rows(run_a)
    losses = [r["loss"] for r in rows]
    sps_deterministic = steps_per_second(rows, 5, 20)  # the step-20 save falls after 19
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"[train] UNet-XL B=64 pad 224 under cuDNN's deterministic algorithms: "
          f"{sps_deterministic:.3f} steps/s (steps 5-19 over their host time), mean loss "
          f"{first10:.4f} over the first 10 steps and {last10:.4f} over the last 10 [{card}]",
          flush=True)
    if not (np.isfinite(losses).all() and len(losses) == 30):
        raise SystemExit(f"UNet-XL training: losses {losses}")
    ema_fp = params_fingerprint(to_flax_params(loop.state.ema))
    del loop

    run_b.mkdir(parents=True)
    for name in ("ckpt_000000020.pth", "args.json"):
        shutil.copy(run_a / name, run_b / name)
    with deterministic_cudnn():
        loop_b, seconds_b, launches_b = run_train(XL_TRAIN, run_b, "UNet-XL resumed 20 -> 30",
                                                  ("fused_conv_gn_mish", 10 * XL_TRAIN_HALVES))
    exact, diff = same_checkpoint(run_a / "ckpt_000000030.pth", run_b / "ckpt_000000030.pth")
    print(f"[train] resume from step 20: step-30 params and EMA bit for bit {exact} "
          f"(max |diff| {diff:.3e})", flush=True)
    if loop_b.resume_step != 20 or not exact:
        raise SystemExit("UNet-XL: the resumed run's step 30 differs from the straight run's")
    del loop_b

    npz = run_a / "ema_000000030.npz"
    with np.load(npz) as z:
        written = str(z["__params_fingerprint__"])
    argv = ["--model_path", str(npz), "--edit_mode", "benchmark_sparse", "--num_samples", "2",
            "--num_repetitions", "1"] + DDIM20
    res, cli_s, cli_launches = run_cli("conditional", argv, "train_xl_ema30")
    model = load_model_for_sampling(parse_cli_args(argv), dev)[0]
    loaded = params_fingerprint(to_flax_params(model.state_dict()))
    print(f"[train] conditional on the step-30 EMA (DDIM-20, CFG 2.5, 2 samples): {cli_s:.2f} s, "
          f"motion {res['motion'].shape} finite {bool(np.isfinite(res['motion']).all())}; "
          f"fingerprint {loaded}, training wrote {written}, training's EMA {ema_fp}", flush=True)
    if not (np.isfinite(res["motion"]).all() and loaded == written == ema_fp
            and cli_launches["fused_conv_gn_mish"] == TRAIN_SAMPLE_STEPS * XL_TRAIN_HALVES):
        raise SystemExit("the step-30 EMA checkpoint does not sample as training wrote it")
    del model
    for d in (run_a, run_b):
        drop_checkpoints(d)

    # the CLI's settings: cuDNN's default algorithms, one save at the end (after step 29)
    torch.cuda.reset_peak_memory_stats()
    loop_t, seconds_t, launches_t = run_train(XL_TRAIN + ["--save_interval", "30"], run_t,
                                              "UNet-XL 30 steps, cuDNN's defaults",
                                              ("fused_conv_gn_mish", 30 * XL_TRAIN_HALVES))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sps = steps_per_second(progress_rows(run_t), 5)
    drop_checkpoints(run_t)
    print(f"[train] UNet-XL B=64 pad 224 under cuDNN's defaults, as training.train runs: "
          f"{sps:.3f} steps/s (steps 5-29 over their host time), peak memory {peak_gb:.2f} GB "
          f"of the card's {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB "
          f"[{card}]", flush=True)

    split = step_split(loop_t, "UNet-XL B=64 pad 224 (cuDNN's default algorithms)", card)
    shapes = record_resblock_shapes(
        loop_t.model, *train_forward_inputs(loop_t))
    if sum(shapes.values()) != XL_TRAIN_HALVES:
        raise SystemExit(f"expected {XL_TRAIN_HALVES} halves in a training forward: {shapes}")
    rows_b64 = f32_resblock_rows("UNet-XL training pad 224", shapes, 64, dev)
    return dict(loop=loop_t, launches=launches["fused_conv_gn_mish"],
                resume_launches=launches_b["fused_conv_gn_mish"],
                timed_launches=launches_t["fused_conv_gn_mish"],
                sample_launches=cli_launches["fused_conv_gn_mish"], seconds=seconds,
                seconds_timed=seconds_t, steps_per_sec=sps,
                steps_per_sec_deterministic=sps_deterministic, peak_memory_gb=peak_gb,
                loss_first10=first10, loss_last10=last10, resume_bit_exact=exact,
                fingerprint=written, split=split, resblock_rows=rows_b64)


def train_forward_inputs(loop):
    """One training forward's inputs as the step gives them to the model (the
    keyframes of a fixed mask, bf16 with use_fp16), for shape recording."""
    data, n = loop.device_data
    batch = loop._gather(data, np.arange(loop.args.batch_size) % n)
    dt = torch.bfloat16 if loop.tcfg.use_bf16 else torch.float32
    x = batch["motion"].to(dt)
    t = torch.full((x.shape[0],), 500, device=x.device)
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    mask[:, ::10] = True
    return x, t, {"text_embed": batch["text_embed"]}, dict(obs_x0=x, obs_mask=mask)


def train_phase22(dev, card):
    """MDM training through main: 20 steps with dropout and condition dropout."""
    import shutil

    out = TRAIN_OUT / "mdm"
    shutil.rmtree(out, ignore_errors=True)
    loop, seconds, launches = run_train(MDM_TRAIN, out, "MDM 20 steps",
                                        ("fused_self_attention", 20 * MDM_TRAIN_ATTENTIONS))
    rows = progress_rows(out)
    losses = [r["loss"] for r in rows]
    sps = steps_per_second(rows, 5)
    if not (np.isfinite(losses).all() and len(losses) == 20):
        raise SystemExit(f"MDM training: losses {losses}")
    if not (loop.model.dropout == 0.1 and loop.model.cond_mask_prob == 0.1):
        raise SystemExit("MDM trained without its dropout or condition dropout")
    drop_checkpoints(out)
    print(f"[train] MDM B=64 T=196: {sps:.3f} steps/s (steps 5-19 over their host time), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} [{card}]", flush=True)
    split = step_split(loop, "MDM B=64", card)
    return dict(loop=loop, launches=launches["fused_self_attention"], seconds=seconds,
                steps_per_sec=sps, loss_first=losses[0], loss_last=losses[-1], split=split)


def parameter_leaves(named, kind):
    """{name: tensor} of a model's parameters for phase 23, MDM's qkv biases split
    into their query and value thirds and their key third: the key bias's gradient
    is zero up to rounding (softmax ignores a constant added to every key), so
    its update is Adam's normalised rounding noise and is held apart."""
    out = {}
    for n, t in named.items():
        if kind == "mdm" and n.endswith("qkv.bias"):
            d = t.shape[0] // 3
            out[n + "[q,v]"] = torch.cat([t[:d], t[2 * d:]])
            out[n + "[k]"] = t[d:2 * d]
        else:
            out[n] = t
    return out


def train_step_pair(loop, swap, kind, label):
    """One train step through the kernel and one with `swap` in place, from the
    same weights, the same generator states and the training run's warmed AdamW
    state (moments and count): the loss, each parameter's gradient and each
    parameter's update compared; between the two, the kernel's forward on the
    weights the kernel step's optimizer just updated (forward_after_step)."""
    import copy

    from condmdi_tpu_torch.training.loop import StepDraws, create_train_state, make_train_step

    model, tcfg = loop.model, loop.tcfg
    gen = torch.Generator().manual_seed(31)
    with torch.no_grad():  # perturbed, so that no zero-initialised layer hides a difference
        for _, p in sorted(model.named_parameters()):
            p.add_((0.02 * torch.randn(p.shape, generator=gen)).to(p.device))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    warm, warm_step = loop.state.optimizer.state_dict(), loop.state.step
    data, n_items = loop.device_data
    batch = loop._gather(data, np.arange(loop.args.batch_size) % n_items)
    results, after = [], None
    for plain in (False, True):
        model.load_state_dict(start)
        state = create_train_state(model, tcfg, loop.sched)
        state.optimizer.load_state_dict(copy.deepcopy(warm))  # its tensors, not the run's
        state.step = warm_step
        step = make_train_step(model, loop.sched, loop.dcfg, tcfg)
        draws = StepDraws(torch.Generator(batch["motion"].device).manual_seed(5),
                          torch.Generator().manual_seed(6))
        with swap() if plain else contextlib.nullcontext():
            metrics = step(state, batch, draws)
        named = dict(model.named_parameters())
        results.append(dict(
            loss=float(metrics["loss"]),
            grads=parameter_leaves({k: p.grad.detach().clone() for k, p in named.items()}, kind),
            params=parameter_leaves({k: p.detach().clone() for k, p in named.items()}, kind)))
        del state
        if not plain:
            after = forward_after_step(loop, kind)
    k, p = results
    first = parameter_leaves({name: start[name] for name in named}, kind)
    del start, warm
    loss_err = abs(k["loss"] - p["loss"])

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    grad_err = rel(torch.cat([g.flatten() for g in k["grads"].values()]),
                   torch.cat([g.flatten() for g in p["grads"].values()]))
    key_bias = [n for n in p["grads"] if n.endswith("[k]")]
    leaves = [n for n in p["grads"] if n not in key_bias]
    bf16 = [n for n in leaves if n.startswith(BF16_GRAD_LEAVES)]
    if len(bf16) != (4 if kind == "xl" and tcfg.use_bf16 else 0):
        raise SystemExit(f"{label}: bfloat16-gradient leaves {bf16} with use_bf16 "
                         f"{tcfg.use_bf16}")
    g_errs = {n: rel(k["grads"][n], p["grads"][n]) for n in leaves}
    u_errs = {n: float((k["params"][n] - p["params"][n]).norm()
                       / (p["params"][n] - first[n]).norm().clamp(min=1e-30)) for n in leaves}
    lr = tcfg.lr
    key_err = max((float((k["params"][n] - p["params"][n]).abs().max()) for n in key_bias),
                  default=0.0)

    def worst(errs, names):
        return sorted(((errs[n], n) for n in names), reverse=True)

    f32 = [n for n in leaves if n not in bf16]
    readings = {"grad_f32": worst(g_errs, f32), "grad_bf16": worst(g_errs, bf16),
                "update_f32": worst(u_errs, f32), "update_bf16": worst(u_errs, bf16)}
    limits = {"grad_f32": TRAIN_GRAD_TOL, "grad_bf16": TRAIN_GRAD_BF16_TOL,
              "update_f32": TRAIN_UPDATE_TOL, "update_bf16": TRAIN_UPDATE_BF16_TOL}

    def show(key):
        top = readings[key][:3]
        return (f"{key} at most " + ", ".join(f"{e:.2e} {n}" for e, n in top)
                + f" (tol {limits[key]:.0e}, {len(readings[key])} tensors)") if top else ""

    print(f"[train] {label} one step from the run's warmed AdamW state (step {warm_step}), "
          f"kernel against plain: loss {k['loss']:.6f} vs {p['loss']:.6f} (|diff| "
          f"{loss_err:.2e}, tol {TRAIN_LOSS_TOL:.0e} x (1+|plain|)); the whole gradient "
          f"|diff| / |plain| {grad_err:.2e}; per parameter tensor |diff| / |plain| of the "
          f"gradient and |diff| / |plain update| of the update: "
          + "; ".join(show(key) for key in readings if readings[key])
          + (f"; attention key biases max |diff| {key_err:.2e} (tol "
             f"{TRAIN_KEY_BIAS_TOL:.0e} lr = {TRAIN_KEY_BIAS_TOL * lr:.0e})"
             if key_bias else ""), flush=True)
    ok = loss_err <= TRAIN_LOSS_TOL * (1 + abs(p["loss"])) and key_err <= TRAIN_KEY_BIAS_TOL * lr
    ok = ok and all(e <= limits[key] for key in readings for e, _ in readings[key])
    if not ok:
        raise SystemExit(f"{label}: the kernel path's train step disagrees with the plain path")
    return dict(loss_kernel=k["loss"], loss_plain=p["loss"], loss_abs_err=loss_err,
                grad_rel_err=grad_err, warm_step=warm_step, key_bias_max_abs_err=key_err,
                **{f"{key}_max_rel_err": (readings[key][0][0] if readings[key] else None)
                   for key in readings},
                **{f"{key}_worst": (readings[key][0][1] if readings[key] else None)
                   for key in readings},
                after_step=after)


def forward_after_step(loop, kind):
    """The stale-packed-weight check: after optimizer.step(), each kernel call of
    one forward against its plain version on the same (updated) weights within
    F32_TOL x (1 + |plain|), and the whole output against the swapped forward
    within DDIM_TOL."""
    import condmdi_tpu_torch.models.unet as unet_mod
    import condmdi_tpu_torch.ops.attention as attn
    from condmdi_tpu_torch.ops.resblock import reference_conv_gn_mish

    x, t, y, kw = train_forward_inputs(loop)
    model = loop.model
    if kind == "mdm":
        x, kw = x.float(), {}
    errs = []
    if kind == "xl":
        real, owner, name = unet_mod.fused_conv_gn_mish, unet_mod, "fused_conv_gn_mish"

        def check(*a, packed=None, **k):
            got = real(*a, packed=packed, **k)
            want = reference_conv_gn_mish(*a, **k)
            errs.append(float(((got - want).abs() / (1 + want.abs())).max()))
            return got
        swap = resblock_swapped_for_plain
    else:
        real, owner, name = attn._launch, attn, "_launch"

        def check(q, k, v, heads):
            got = real(q, k, v, heads)
            want = attn._xla_attention(q, k, v, heads)
            errs.append(float(((got - want).abs() / (1 + want.abs())).max()))
            return got
        swap = attention_swapped_for_plain
    with torch.no_grad():
        setattr(owner, name, check)
        try:
            out = model(x, t, y, **kw)
        finally:
            setattr(owner, name, real)
        with swap():
            plain = model(x, t, y, **kw)
    out_err = float((out - plain).abs().max())
    calls = XL_TRAIN_HALVES if kind == "xl" else MDM_TRAIN_ATTENTIONS
    print(f"[train] {kind} forward after the optimizer step: {len(errs)} kernel calls "
          f"(expected {calls}), max |kernel - plain| / (1 + |plain|) "
          f"{max(errs, default=0.0):.2e} (tol {F32_TOL:.0e}); output max |kernel - plain| "
          f"{out_err:.2e} (tol {DDIM_TOL:.0e})", flush=True)
    if not (len(errs) == calls and max(errs, default=0.0) <= F32_TOL and out_err <= DDIM_TOL):
        raise SystemExit(f"{kind}: the kernel reads stale weights after the optimizer step")
    return dict(calls=len(errs), max_rel_err=max(errs, default=0.0), output_max_abs_err=out_err)


def train_phase23(xl_loop, mdm_loop):
    return {"xl": train_step_pair(xl_loop, resblock_swapped_for_plain, "xl", "UNet-XL"),
            "mdm": train_step_pair(mdm_loop, attention_swapped_for_plain, "mdm", "MDM")}


# --------------------------------------------------------------------------- #
# phase 24: the paths the JAX package compiles, with CUDA graphs and without
# --------------------------------------------------------------------------- #
GRAPH_OUT = ROOT / "chiprun_out" / "graphs"
GATE_TRAIN_STEPS, GATE_TRAIN_DISPATCH = 50, 25  # the gate configuration: 2 dispatches of 25
FEW_TRAIN_STEPS = 6  # UNet-XL and MDM through main; steps 2 on are replays
# the host's calls that put work on the card, as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


@contextlib.contextmanager
def graphs_off():
    """SamplePipeline and TrainLoop built with cuda_graphs=False while open (the CLIs,
    evals.run, training.train.main and this script's `pipeline` build their own)."""
    import functools

    import condmdi_tpu_torch.sampling.pipeline as pipeline_mod
    import condmdi_tpu_torch.training.train as train_mod

    saved = pipeline_mod.SamplePipeline, train_mod.TrainLoop
    pipeline_mod.SamplePipeline = functools.partial(saved[0], cuda_graphs=False)
    train_mod.TrainLoop = functools.partial(saved[1], cuda_graphs=False)
    try:
        yield
    finally:
        pipeline_mod.SamplePipeline, train_mod.TrainLoop = saved


@contextlib.contextmanager
def sampling_clock(record):
    """While open, every sampling program's run is timed on the host clock
    (synchronised at both ends) and appended to `record` with its program."""
    import condmdi_tpu_torch.sampling.pipeline as pipeline_mod

    run = pipeline_mod.SamplingProgram.run

    def timed(prog, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(prog, *a, **kw)
        torch.cuda.synchronize()
        record.append((prog, time.perf_counter() - t0))
        return out

    pipeline_mod.SamplingProgram.run = timed
    try:
        yield
    finally:
        pipeline_mod.SamplingProgram.run = run


def step_costs(step, profiler_time=False, n=5):
    """One step's device ms, the card's kernels and copies (torch.profiler over n
    steps) and the host's calls that put work on the card (LAUNCH_CALLS). Device
    ms: one step queued behind a spin kernel (timed_ms), or, with
    `profiler_time` (a step that waits for the card, or launches more than the
    launch queue holds), the profiler's kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernel_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
                    for e in device)
    calls = sum(e.count for e in events
                if e.device_type == DeviceType.CPU and e.key in LAUNCH_CALLS) / n
    profiled_ms = kernel_us / n / 1e3 if kernel_us else None
    device_ms = profiled_ms if profiler_time else timed_ms(step, [()], reps=5, iters=1)[0]
    return dict(device_ms=device_ms, profiler_kernel_ms=profiled_ms,
                device_ops=sum(e.count for e in device) / n, launch_calls=calls)


def program_steps(prog):
    """(one replayed step, the same step run eagerly) of a sampling program at its
    first step, on its buffers: t and the noise written, then the branch's graph
    replayed, or the step's body called."""
    from condmdi_tpu_torch.diffusion.sampling import at_model_step, step_body

    sched, buf = prog.pipe.sched, prog.buffers
    ti = sched.num_timesteps - 1
    graph, body = prog._graph(prog._branch(ti)), step_body(prog.step, buf)

    def prepare():
        buf.t.fill_(ti)
        torch.randn(buf.z.shape, out=buf.z)

    def replayed():
        prepare()
        return graph(check=False)

    def eager():
        with at_model_step(sched.model_t_host(ti)):
            prepare()
            return body()

    return replayed, eager


def graph_row(label, unit, runs, equal, card):
    """Print one path's line: rate, host ms a step against device ms, idle share,
    the host's launch calls and the card's kernels a step, both ways."""
    for r in runs.values():
        r["idle"] = (None if r["device_ms"] is None
                     else 1.0 - r["device_ms"] / r["host_ms_per_step"])

    def one(name):
        r = runs[name]
        idle = "not measured" if r["idle"] is None else f"{r['idle']:.1%}"
        device = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        return (f"{name}: {r['rate']:.4f} {unit}, host {r['host_ms_per_step']:.4f} ms a step, "
                f"device {device} ms, idle {idle}, {r['launch_calls']:.1f} host launch calls "
                f"and {r['device_ops']:.1f} device kernels and copies a step")

    g, e = runs["graphs"], runs["eager"]
    print(f"[graphs] {card}: {label}: {one('graphs')}; {one('eager')}; speed-up "
          f"{g['rate'] / e['rate']:.3f}x; graph run equals eager run bit for bit: {equal}",
          flush=True)
    if not equal:
        raise SystemExit(f"{label}: the CUDA-graph run differs from the eager run")
    return dict(label=label, unit=unit, bit_equal=equal, **runs)


def graph_serve(dev, card, label, apply_fn, requests, expect):
    """Phase 4's server over `apply_fn`, with graphs and without: the 4 requests'
    motions, samples/s, the launches (`expect`, per kernel). `requests()` makes
    them (a request answers once)."""
    runs, outs, progs = {}, {}, {}
    for name in ("graphs", "eager"):
        record, outs[name] = [], []
        with graphs_off() if name == "eager" else contextlib.nullcontext(), \
                sampling_clock(record):
            served = serve_requests(pipeline(apply_fn, schedule(SERVE_STEPS), dev), requests(),
                                    outs[name])
        for kern, count in expect.items():
            if served["launches"][kern] != count:
                raise SystemExit(f"{label} ({name}): {kern} launches "
                                 f"{served['launches'][kern]} != {count}")
        (prog, seconds), = record
        progs[name] = prog
        runs[name] = dict(rate=served["samples_per_s"], wall_s=served["wall_s"],
                          host_ms_per_step=seconds * 1e3 / SERVE_STEPS,
                          launches=served["launches"])
    replayed, eager = program_steps(progs["graphs"])
    runs["graphs"].update(step_costs(replayed))
    runs["eager"].update(step_costs(eager))
    equal = all(np.array_equal(a, b) for a, b in zip(outs["graphs"], outs["eager"]))
    return graph_row(label, "samples/s", runs, equal, card)


def graph_sampling_cli(card, label, run, samples, steps, expect):
    """A CLI or evals.run through its main, with graphs and without: `run()` returns
    (the generated motions, launches); samples/s over the sampling runs' host time."""
    runs, outs, progs = {}, {}, {}
    for name in ("graphs", "eager"):
        record = []
        with graphs_off() if name == "eager" else contextlib.nullcontext(), \
                sampling_clock(record):
            outs[name], launches = run(name)
        for kern, count in expect.items():
            if launches[kern] != count:
                raise SystemExit(f"{label} ({name}): {kern} launches {launches[kern]} != {count}")
        seconds = sum(sec for _, sec in record)
        progs[name] = record[-1][0]
        runs[name] = dict(rate=samples / seconds, sampling_s=seconds,
                          host_ms_per_step=seconds * 1e3 / (steps * len(record)),
                          launches=launches)
    replayed, eager = program_steps(progs["graphs"])
    runs["graphs"].update(step_costs(replayed))
    runs["eager"].update(step_costs(eager))
    return graph_row(label, "samples/s", runs, np.array_equal(outs["graphs"], outs["eager"]),
                     card)


def graph_train(card, label, argv, save_root, expect, timed_steps):
    """training.train.main with graphs and without, under cuDNN's deterministic
    algorithms (their default weight gradient sums in an order that changes from
    run to run): the parameters and EMA at the end equal bit for bit. Then, still
    under them, each run's step function for `timed_steps` more steps on one
    batch from its device cache: steps/s and host ms a step (host clock,
    synchronised at both ends), and one step's costs."""
    import gc
    import shutil

    runs, loops = {}, {}
    for name in ("graphs", "eager"):
        gc.collect()  # an earlier run's graph and its memory pool sit in reference cycles
        torch.cuda.empty_cache()
        save_dir = save_root / name
        shutil.rmtree(save_dir, ignore_errors=True)
        with graphs_off() if name == "eager" else contextlib.nullcontext(), \
                deterministic_cudnn():
            loop, seconds, launches = run_train(argv, save_dir, f"{label} ({name})", expect)
        drop_checkpoints(save_dir)
        loops[name] = loop
        runs[name] = dict(main_s=seconds, launches=launches)
    got, want = loops["graphs"], loops["eager"]
    equal = all(torch.equal(a, b) for a, b in zip(got.model.state_dict().values(),
                                                  want.model.state_dict().values()))
    equal = equal and all(torch.equal(got.state.ema[k], want.state.ema[k])
                          for k in want.state.ema)
    for name, loop in loops.items():
        data, n = loop.device_data
        batch = loop._gather(data, np.arange(loop.args.batch_size) % n)

        def step():
            return loop.step_fn(loop.state, batch, loop.draws)

        with deterministic_cudnn():
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(timed_steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[name].update(rate=timed_steps / wall, host_ms_per_step=wall * 1e3 / timed_steps)
            runs[name].update(step_costs(step, profiler_time=name == "eager"))
    return graph_row(label, "steps/s", runs, equal, card)


def argv_from_args_json(path: Path) -> list[str]:
    argv = []
    for key, value in json.loads(path.read_text()).items():
        if value is None:
            continue
        if isinstance(value, bool):
            value = "true" if value else "false"
        argv.append(f"--{key}")
        argv.extend(str(v) for v in value) if isinstance(value, list) else argv.append(str(value))
    return argv


def graphs_phase24(dev, card, int8_model):
    """Every path the JAX package compiles, with CUDA graphs (the default) and with
    cuda_graphs=False, in this process: served UNet-XL bf16, served MDM, the int8
    mixed step, the gate conditional CLI, evals.run on the gate (one batch of
    32), the gate configuration's training (50 steps, 2 dispatches of 25) and a
    few steps of UNet-XL and MDM training. Each graph run must equal its eager run
    bit for bit."""
    import os

    from condmdi_tpu_torch.models.text import HashTextEncoder
    from condmdi_tpu_torch.models.unet import MixedStepDenoiser
    from condmdi_tpu_torch.serving import MotionRequest

    os.environ.setdefault("CONDMDI_SYNTH_CACHE", str(ROOT / ".chipwork" / "synth_cache"))
    out = {}
    n, S = SERVE_REQUESTS, SERVE_STEPS
    text, obs, mask = keyframe_inputs(n, 1)

    def keyframe_requests():
        return [MotionRequest(text_embed=text[i].numpy(), obs_x0=obs[i].numpy(),
                              obs_mask=mask[i].numpy(), seed=i) for i in range(n)]

    xl = build_xl(dev, torch.bfloat16)
    out["serve_xl"] = graph_serve(
        dev, card, f"served UNet-XL bf16, {n} keyframe requests, {S}-step DDPM, CFG {GUIDANCE}",
        lambda x, t, y, **kw: xl(x.to(torch.bfloat16), t, y, **kw).float(), keyframe_requests,
        {"fused_conv_gn_mish": 33 * S})
    del xl
    mdm = build_mdm(dev, torch.bfloat16)
    texts = HashTextEncoder().encode(PROMPTS)
    out["serve_mdm"] = graph_serve(
        dev, card, f"served MDM bf16, {n} text requests, {S}-step DDPM, CFG {GUIDANCE}",
        lambda x, t, y, **_: mdm(x.to(torch.bfloat16), t, y).float(),
        lambda: [MotionRequest(text_embed=texts[i], seed=i) for i in range(n)],
        {"fused_self_attention": 8 * S})
    del mdm
    mixed = MixedStepDenoiser(int8_model, K_FLOAT)
    n_float = int((schedule(S).timestep_map < K_FLOAT).sum())
    out["serve_mixed"] = graph_serve(
        dev, card, f"served int8 mixed step (k_float {K_FLOAT}), {n} keyframe requests",
        lambda x, t, y, **kw: mixed(x.to(torch.bfloat16), t, y, **kw).float(),
        keyframe_requests, {"int8_conv1d": 41 * (S - n_float), "fused_conv_gn_mish": 33 * n_float})
    del mixed

    def conditional(name):
        res, _, launches = run_cli("conditional", GATE_CLI, f"graphs_gate_{name}")
        return res["motion"], launches

    out["cli_gate"] = graph_sampling_cli(
        card, f"conditional on the gate checkpoint, {CLI_SAMPLES} samples, {CLI_STEPS}-step "
        "DDPM, CFG 2.5, f32", conditional, CLI_SAMPLES, CLI_STEPS,
        {"fused_conv_gn_mish": GATE_HALVES * CLI_STEPS})

    def evals_run(name):
        assert EVAL_GATE[-2] == "--num_samples"
        run = run_eval("run", EVAL_GATE[:-1] + [str(EVAL_BATCH)], f"graphs_gate_{name}")
        return run["outputs"][0]["sample"], run["launches"]

    out["eval_gate"] = graph_sampling_cli(
        card, f"evals.run on the gate checkpoint, one batch of {EVAL_BATCH}, 1000-step DDPM, f32",
        evals_run, EVAL_BATCH, CLI_STEPS, {"fused_conv_gn_mish": GATE_HALVES * CLI_STEPS})

    gate_argv = argv_from_args_json(ROOT / "save" / "synthetic_unet_m" / "args.json") + [
        "--num_steps", str(GATE_TRAIN_STEPS), "--steps_per_dispatch", str(GATE_TRAIN_DISPATCH),
        "--save_interval", str(10 * GATE_TRAIN_STEPS), "--log_interval", str(GATE_TRAIN_DISPATCH),
        "--text_encoder", "hash", "--data_dir", str(ROOT / "chiprun_out" / "no_humanml3d")]
    out["train_gate"] = graph_train(
        card, f"the gate configuration's training, {GATE_TRAIN_STEPS} steps in dispatches of "
        f"{GATE_TRAIN_DISPATCH}", gate_argv, GRAPH_OUT / "train_gate",
        ("fused_conv_gn_mish", GATE_HALVES * GATE_TRAIN_STEPS), 20)
    few = ["--num_steps", str(FEW_TRAIN_STEPS), "--save_interval", str(10 * FEW_TRAIN_STEPS)]
    out["train_xl"] = graph_train(
        card, f"UNet-XL training, {FEW_TRAIN_STEPS} steps", XL_TRAIN + few,
        GRAPH_OUT / "train_xl", ("fused_conv_gn_mish", XL_TRAIN_HALVES * FEW_TRAIN_STEPS), 5)
    out["train_mdm"] = graph_train(
        card, f"MDM training, {FEW_TRAIN_STEPS} steps", MDM_TRAIN + few,
        GRAPH_OUT / "train_mdm", ("fused_self_attention", MDM_TRAIN_ATTENTIONS * FEW_TRAIN_STEPS),
        20)
    return out


# --------------------------------------------------------------------------- #
# phases 25-28: GMD guided generation, its protocol, PLMS and DDIM reverse
# --------------------------------------------------------------------------- #
GMD_OUT = ROOT / "chiprun_out" / "gmd"
TRAJ_CKPT = ROOT / ".chipwork" / "gmd"  # 33 MB a checkpoint: not brought back
# 2 prompts; the sampler's depth cut from the CLIs' 1000 steps to 100, widths untouched,
# to keep the whole script within its time limit
GMD_SAMPLES, GMD_STEPS = 2, 100
TRAJ_FEATS, TRAJ_HALVES = 4, 25  # traj_unet_adagn_swx: (rot, x, z, y); 12 resblocks + final
TRAJ_GROUP_WIDTHS = {8, 16, 32}  # its 64, 128 and 256 channels in GroupNorm(8)
# the motion card: UNet-XL at the defaults (latent 512, dim_mults 2 2 2 2, 196 frames padded
# to 224), abs-root features, not keyframe-conditioned, Flax's initialisation from --seed
# (unet_zero off); the trajectory model from --traj_model_path (its args.json); the CLI's
# default classifier_scale 100 and seed 10
GMD_CLI = ["--arch", "unet", "--abs_3d", "true", "--unet_zero", "false", "--num_samples",
           str(GMD_SAMPLES), "--num_repetitions", "1", "--text_encoder", "hash",
           "--diffusion_steps", str(GMD_STEPS)]
# resblock launches per sampler step: the trajectory model's 25 halves (stage 1, one forward
# a step; its backward recomputes the plain version) and UNet-XL's 33 (stage 2, or the one
# stage; CFG folds into one batch-doubled forward)
GMD_MODES = {"kps": TRAJ_HALVES + 33, "sdf": TRAJ_HALVES + 33, "trajectory": 33,
             "mdm_legacy": 33}
CLI_KEYS["generate_gmd"] = {"motion", "joints", "text", "lengths", "kframes", "obstacles",
                            "guidance_mode", "pattern", "text_encoder", "random_init_model"}
COND_REPORT = ROOT / "save" / "eval_out" / "eval_condition_debug.json"  # the JAX report's form
PLMS_STEPS, PLMS_ORDERS = 100, (2, 4)


@functools.lru_cache(maxsize=None)
def traj_checkpoint(xz_only=False) -> str:
    """traj_unet_adagn_swx (unet_zero off) as a checkpoint the CLIs read: its args.json
    and Flax's initialisation from the CLIs' default seed 10 as a flat npz, written
    from the port's replay of Flax's init (the weights the JAX CLI draws)."""
    from condmdi_tpu_torch.models.factory import create_model
    from condmdi_tpu_torch.models.flax_init import load_flax_init
    from condmdi_tpu_torch.utils.config import save_args_json, traj_unet_adagn_swx
    from condmdi_tpu_torch.weights import flatten_flax_params, to_flax_params

    args = traj_unet_adagn_swx(unet_zero=False, xz_only=xz_only)
    folder = TRAJ_CKPT / ("traj_xz_only" if xz_only else "traj")
    model = load_flax_init(create_model(args, "cpu"), 10)
    folder.mkdir(parents=True, exist_ok=True)
    save_args_json(args, folder / "args.json")
    path = folder / "model.npz"
    np.savez(path, **flatten_flax_params(to_flax_params(model.state_dict())))
    return str(path)


def traj_model(dev, xz_only=False):
    """The trajectory model as the CLIs load it from traj_checkpoint(), with its
    schedule and diffusion config."""
    from condmdi_tpu_torch.sampling.synthesize import load_model_for_sampling
    from condmdi_tpu_torch.utils.config import GMDGenerateArgs, parse_args

    args = parse_args(GMDGenerateArgs, ["--model_path", traj_checkpoint(xz_only),
                                        "--unet_zero", "false"])
    return load_model_for_sampling(args, dev)


def traj_census(model, B, dev, seed=25):
    x = seeded_noise((B, T_FRAMES, TRAJ_FEATS), dev, seed=seed)
    y = {"text_embed": seeded_noise((B, 512), dev, seed=seed + 1)}
    return record_resblock_shapes(model, x, torch.full((B,), 500, device=dev), y, {})


def guided_step_gradient(dev, model, sched, dcfg, B=GMD_SAMPLES):
    """d(-loss)/dx of one guided stage-1 step (the zigzag keyframes, traj_only, the
    model at t = 600 through p_mean_variance), kernel path against plain path
    within F32_TOL * (1 + |plain|); the kernel path's launches (one forward)."""
    from condmdi_tpu_torch.diffusion.gaussian import p_mean_variance
    from condmdi_tpu_torch.sampling.gmd import CondKeyLocations, get_kframes, kframes_to_target
    from condmdi_tpu_torch.utils.assets import NormStats

    sched = sched.to(dev)
    target, mask = kframes_to_target(get_kframes("zigzag"), B, T_FRAMES, dev)
    guide = CondKeyLocations(target, mask, NormStats(np.zeros(4, np.float32),
                                                     np.ones(4, np.float32)), traj_only=True)
    x = seeded_noise((B, T_FRAMES, TRAJ_FEATS), dev, seed=27)
    y = {"text_embed": seeded_noise((B, 512), dev, seed=28)}
    t = torch.full((B,), 600, device=dev)

    def grad():
        z = x.clone().requires_grad_(True)
        out = p_mean_variance(lambda xx, tt: model(xx, tt, y), sched, dcfg, z, t)
        (g,) = torch.autograd.grad(-guide.loss_fn(out["pred_xstart"], sched.model_t(t)), z)
        return g

    reset_counts()
    got = grad()
    torch.cuda.synchronize()
    launches = read_counts()["fused_conv_gn_mish"]
    with resblock_swapped_for_plain():
        want = grad()
    err = (got - want).abs()
    bad = int((err > F32_TOL * (1 + want.abs())).sum())
    print(f"[gmd] one guided stage-1 step at B={B}: d(-loss)/dx kernel path against plain path "
          f"max|diff| {err.max().item():.3e} (tol {F32_TOL:.0e}*(1+|plain|)), {bad} outside, "
          f"max|grad| {want.abs().max().item():.3e}; resblock launches {launches} (expected "
          f"{TRAJ_HALVES})", flush=True)
    if bad or launches != TRAJ_HALVES or not torch.isfinite(got).all() or not want.abs().max() > 0:
        raise SystemExit("the guided step's gradient through the kernel disagrees with plain")
    return dict(max_abs_err=err.max().item(), max_abs_grad=want.abs().max().item(),
                launches=launches)


def gmd_phase25(dev, card):
    """The trajectory model's resblock halves at full width (pad 224): the census at
    B = 2 (the CLI) and 32 (the protocol), each shape kernel against plain and timed
    (f32_resblock_rows); the xz_only model's first half (2 input channels); one guided
    step's gradient, kernel path against plain path."""
    model, sched, dcfg = traj_model(dev)
    out = {}
    for B in (GMD_SAMPLES, EVAL_BATCH):
        shapes = traj_census(model, B, dev)
        widths = {cout // 8 for (_, cout, *_rest) in shapes}
        firsts = {xc for (cin, *_mid, xc) in shapes if cin == TRAJ_FEATS}
        if sum(shapes.values()) != TRAJ_HALVES or widths != TRAJ_GROUP_WIDTHS or firsts != {8}:
            raise SystemExit(f"trajectory model census at B={B}: {shapes}")
        out[f"B={B}"] = f32_resblock_rows("trajectory model pad 224", shapes, B, dev)
    xz, _, _ = traj_model(dev, xz_only=True)
    gen = torch.Generator().manual_seed(29)
    out["xz_only_first_half"] = []
    for B in (GMD_SAMPLES, EVAL_BATCH):
        shapes = traj_census(xz, B, dev)
        (first,) = [s for s in shapes if s[0] == 2]
        cin, cout, T, ada, res, xc = first
        out["xz_only_first_half"].append(dict(
            B=B, cin=cin, x_channels=xc, max_abs_err_f32=kernel_against_plain(
                B, T, cin, cout, ada, res, xc, torch.float32, F32_TOL, gen, dev)))
    out["guided_gradient"] = guided_step_gradient(dev, model, sched, dcfg)
    print(f"[gmd] {card}: trajectory model f32, the {TRAJ_HALVES} halves of one forward: "
          + "; ".join(f"{k} kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, library "
                      f"{v['library_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms"
                      for k, v in out.items() if k.startswith("B=")), flush=True)
    return out


@contextlib.contextmanager
def gmd_clock(record):
    """While open, the guided DDPM loops (`ddpm_sample_loop`, stage 1 of the
    two-stage modes) and every sampling program's run (stage 2, the one-stage
    modes) are timed on the host clock, synchronised at both ends."""
    import condmdi_tpu_torch.diffusion.sampling as sampling_mod

    loop = sampling_mod.ddpm_sample_loop

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loop(*a, **kw)
        torch.cuda.synchronize()
        record.setdefault("stage1_s", []).append(time.perf_counter() - t0)
        return out

    programs = []
    sampling_mod.ddpm_sample_loop = timed
    try:
        with sampling_clock(programs):
            yield
    finally:
        sampling_mod.ddpm_sample_loop = loop
        record["programs"] = programs


@contextlib.contextmanager
def stage_two_recorder(seen):
    """While open, two_stage_generate keeps what its stage 2 got: the inpainting
    state, every step's pred_xstart (the motion pipeline run with
    return_trajectory) and the stage-1 trajectory."""
    import dataclasses

    import condmdi_tpu_torch.sampling.gmd as gmd

    real = gmd.two_stage_generate

    def recording(traj_pipe, motion_pipe, *a, **kw):
        sample = motion_pipe.sample
        sampler = motion_pipe.sampler
        motion_pipe.sampler = dataclasses.replace(sampler, return_trajectory=True)

        def keep(*sa, **skw):
            x, steps = sample(*sa, **skw)
            seen.update(inpaint=skw["inpaint"], pred_xstart=steps)
            return x

        motion_pipe.sample = keep
        try:
            traj, x = real(traj_pipe, motion_pipe, *a, **kw)
        finally:
            del motion_pipe.sample
            motion_pipe.sampler = sampler
        seen["traj"] = traj
        return traj, x

    gmd.two_stage_generate = recording
    try:
        yield
    finally:
        gmd.two_stage_generate = real


def check_stage_two(seen, label):
    """Stage 2 imputed the stage-1 trajectory, rescaled (identity stats here: the
    assets are absent), into channels 0:4 at every step with t >= 1 (the
    imputation's end, impute_until 1), exactly."""
    inp, traj, steps = seen["inpaint"], seen["traj"], seen["pred_xstart"]
    held = inp.inpainting_mask[..., :4].all().item() and not inp.inpainting_mask[..., 4:].any()
    rescaled = torch.equal(inp.inpainted_motion[..., :4], traj)
    on = int(steps.shape[0]) - inp.stop_imputation_at
    kept = (steps[:on, ..., :4] - inp.inpainted_motion[..., :4]).abs().max().item()
    print(f"[gmd] {label}: stage 2's mask holds channels 0:4 {held}, its motion the stage-1 "
          f"trajectory {rescaled}; max|pred_xstart - trajectory| on channels 0:4 over the "
          f"{on} steps with imputation on: {kept:.3e}", flush=True)
    if not (held and rescaled and kept == 0.0):
        raise SystemExit(f"{label}: stage 2 did not impute the stage-1 trajectory")
    return kept


def check_one_stage_imputation(res, mode, label):
    """trajectory and mdm_legacy impute through t = 0: the final motion holds the p2p
    trajectory (abs root: channels 1:3) or its velocities (relative root: 0:3)."""
    from condmdi_tpu_torch.sampling.gmd import get_kframes, interpolate_kframes_trajectory

    traj = interpolate_kframes_trajectory(get_kframes("square"), res["motion"].shape[1])
    if mode == "trajectory":
        got, want = res["motion"][..., 1:3], traj
    else:
        vel = np.diff(traj, axis=0, append=traj[-1:])
        got, want = res["motion"][..., 0:3], np.concatenate([np.zeros_like(vel[:, :1]), vel], -1)
    err = float(np.abs(got - want[None]).max())
    print(f"[gmd] {label}: max|motion - imputed trajectory| {err:.3e}", flush=True)
    if err != 0.0:
        raise SystemExit(f"{label}: the imputed trajectory is not in the motion")
    return err


def gmd_run(mode, argv, label, steps=GMD_STEPS):
    """generate_gmd's main on the card (run_cli: counts set to 0 around it), its stages
    timed; results.npy with the JAX CLI's keys, finite; exact launches."""
    record, seen = {}, {}
    with gmd_clock(record), stage_two_recorder(seen) if mode in ("kps", "sdf") and \
            steps == GMD_STEPS else contextlib.nullcontext():
        res, seconds, launches = run_cli("generate_gmd", argv + ["--guidance_mode", mode], label)
    # mdm_legacy's template cuts the motion to 6 s (120 frames), as the reference's does
    check_cli_result("generate_gmd", res, label, GMD_SAMPLES,
                     T=120 if mode == "mdm_legacy" else T_FRAMES)
    expect = GMD_MODES[mode] * steps
    if launches["fused_conv_gn_mish"] != expect or launches["int8_conv1d"] \
            or launches["fused_self_attention"]:
        raise SystemExit(f"{label}: launches {launches}, expected fused_conv_gn_mish {expect}")
    run = dict(seconds=seconds, samples_per_s=GMD_SAMPLES / seconds, launches=launches,
               stage1_s=sum(record.get("stage1_s", [])),
               sampler_runs_s=[sec for _, sec in record["programs"]],
               programs=[prog for prog, _ in record["programs"]], result=res)
    if seen:
        run["stage2_imputation_max_abs"] = check_stage_two(seen, label)
    return run


def gmd_step_costs(run, guided, label, steps=GMD_STEPS):
    """Host ms a step against device ms (the card's kernel time for one step, by
    torch.profiler: a guided step waits for its gradient) and the idle share, for the
    guided stage (eager, `guided` one step of it) and the replayed stage 2."""
    out = {}
    if guided is not None:
        host = (run["stage1_s"] or run["sampler_runs_s"][0]) * 1e3 / steps
        out["guided"] = dict(host_ms_per_step=host, **step_costs(guided, profiler_time=True))
    replayed = [p for p in run["programs"] if p.buffered]
    if replayed:
        replay, _ = program_steps(replayed[0])
        host = run["sampler_runs_s"][-1] * 1e3 / steps
        out["replayed"] = dict(host_ms_per_step=host, **step_costs(replay))
    for name, c in out.items():
        c["idle"] = 1.0 - c["device_ms"] / c["host_ms_per_step"] if c["device_ms"] else None
        idle = "not measured" if c["idle"] is None else f"{c['idle']:.1%}"
        device = "not measured" if c["device_ms"] is None else f"{c['device_ms']:.4f} ms"
        print(f"[gmd] {label}, {name} stage: host {c['host_ms_per_step']:.4f} ms a step, device "
              f"{device}, idle {idle}, {c['launch_calls']:.1f} host launch calls and "
              f"{c['device_ops']:.1f} device kernels and copies a step", flush=True)
    return out


def guided_step(denoise, sched, dcfg, loss_fn, scale, x):
    """One guided DDPM step on fixed inputs (`SamplerStep` with the run's loss), at
    the middle of the schedule; zero noise."""
    from condmdi_tpu_torch.diffusion.sampling import SamplerStep, at_model_step

    step = SamplerStep("ddpm", denoise, sched, dcfg, cond_loss_fn=loss_fn, cond_scale=scale)
    t = torch.full((x.shape[0],), sched.num_timesteps // 2, device=x.device)
    z = torch.zeros_like(x)

    def one():
        with at_model_step(sched.model_t_host(sched.num_timesteps // 2)):
            return step(x, t, z)[0]

    return one


def gmd_guided_steps(dev, B):
    """(stage-1 guided step of the trajectory model at batch B, the trajectory mode's
    guided UNet-XL step at B under CFG 2.5) on fixed inputs, for their device time."""
    from condmdi_tpu_torch.models.cfg import make_cfg_denoiser, make_plain_denoiser
    from condmdi_tpu_torch.sampling.gmd import CondKeyLocations, get_kframes, kframes_to_target
    from condmdi_tpu_torch.sampling.synthesize import load_model_for_sampling
    from condmdi_tpu_torch.utils.assets import NormStats
    from condmdi_tpu_torch.utils.config import GMDGenerateArgs, parse_args

    model, sched, dcfg = traj_model(dev)
    sched = sched.to(dev)
    y = {"text_embed": seeded_noise((B, 512), dev, seed=30)}
    target, mask = kframes_to_target(get_kframes("zigzag"), B, T_FRAMES, dev)
    ident = NormStats(np.zeros(FEATS, np.float32), np.ones(FEATS, np.float32))
    guide = CondKeyLocations(target, mask, ident, traj_only=True)
    traj = guided_step(make_plain_denoiser(lambda x, t, yy, **_: model(x, t, yy), y), sched,
                       dcfg, guide.loss_fn, 100.0, seeded_noise((B, T_FRAMES, 4), dev, 31))
    if B != GMD_SAMPLES:
        return traj, None
    xl, xsched, xdcfg = load_model_for_sampling(parse_args(GMDGenerateArgs, GMD_CLI), dev)
    xsched = xsched.to(dev)
    guide_xl = CondKeyLocations(target, mask, ident, abs_3d=True)
    motion = guided_step(make_cfg_denoiser(lambda x, t, yy, **_: xl(x, t, yy), y, 2.5), xsched,
                         xdcfg, guide_xl.loss_fn, 100.0, seeded_noise((B, T_FRAMES, FEATS), dev, 32))
    return traj, motion


def gmd_phase26(dev, card):
    """generate_gmd through its main at full width, GMD_STEPS-step DDPM, scale 100: kps,
    sdf, trajectory and mdm_legacy; then each kernel path against plain path through
    the CLI at 20 steps."""
    traj_npz = traj_checkpoint()
    argv = GMD_CLI + ["--traj_model_path", traj_npz]
    out = {}
    for mode in GMD_MODES:
        run = gmd_run(mode, argv, f"gmd_{mode}")
        if mode in ("trajectory", "mdm_legacy"):
            run["imputation_max_abs"] = check_one_stage_imputation(run["result"], mode,
                                                                   f"gmd_{mode}")
        print(f"[gmd] {card}: generate_gmd {mode}, UNet-XL f32{' + trajectory model' if GMD_MODES[mode] > 33 else ''}, "
              f"{GMD_STEPS}-step DDPM, {GMD_SAMPLES} samples: {run['seconds']:.2f} s on the host, "
              f"{run['samples_per_s']:.4f} samples/s (guided stage 1 {run['stage1_s']:.2f} s, "
              f"sampler runs {[round(s, 2) for s in run['sampler_runs_s']]} s); launches "
              f"{run['launches']} (expected fused_conv_gn_mish {GMD_MODES[mode]} x {GMD_STEPS})",
              flush=True)
        out[mode] = run
    traj_step, xl_step = gmd_guided_steps(dev, GMD_SAMPLES)
    for mode, guided in (("kps", traj_step), ("trajectory", xl_step), ("mdm_legacy", None)):
        out[mode]["steps"] = gmd_step_costs(out[mode], guided, f"generate_gmd {mode}")
    for mode, per_step in GMD_MODES.items():
        out[mode]["ddpm20_max_abs_err"] = cli_kernel_vs_plain(
            "generate_gmd", argv + ["--guidance_mode", mode, "--diffusion_steps", "20"],
            f"gmd_{mode}_ddpm20", "fused_conv_gn_mish", per_step, resblock_swapped_for_plain)
    for run in out.values():
        run.pop("programs")
        run.pop("result")
    return out


def gmd_phase27(dev, card):
    """evals.run_condition through its main: one batch of 32, one replication, the
    GMD_STEPS-step DDPM for both models; the report in the committed JAX report's form."""
    argv = ["--eval_mode", "debug", "--max_replications", "1", "--arch", "unet",
            "--unet_zero", "false", "--model_path", "", "--traj_model_path", traj_checkpoint(),
            "--num_samples", str(EVAL_BATCH), "--text_encoder", "hash", "--seed", "10",
            "--diffusion_steps", str(GMD_STEPS)]
    record = {}
    with gmd_clock(record):
        run = run_eval("run_condition", argv, "condition")
    rep, want = run["report"], json.loads(COND_REPORT.read_text())
    expect = (TRAJ_HALVES + 33) * GMD_STEPS
    if set(rep) != set(want) or set(rep["per_replication"]) != set(want["per_replication"]) \
            or set(rep["meta"]) != set(want["meta"]) | {"device_name"}:
        raise SystemExit(f"run_condition: report keys {sorted(rep)} / meta {sorted(rep['meta'])} "
                         f"are not the JAX report's")
    check_eval_report(run, "run_condition")
    if len(rep["traj_error"]["mean"]) != 5 or run["launches"]["fused_conv_gn_mish"] != expect:
        raise SystemExit(f"run_condition: traj_error {rep['traj_error']['mean']}, launches "
                         f"{run['launches']} (expected {expect})")
    run.update(stage1_s=sum(record["stage1_s"]), sampler_runs_s=[s for _, s in record["programs"]],
               programs=[p for p, _ in record["programs"]])
    traj_step, _ = gmd_guided_steps(dev, EVAL_BATCH)
    steps = gmd_step_costs(run, traj_step, "evals.run_condition")
    rate = EVAL_BATCH / run["seconds"]
    print(f"[eval] {card}: evals.run_condition (trajectory model + UNet-XL, f32), "
          f"{GMD_STEPS}-step DDPM, scale 100, one batch of {EVAL_BATCH}: {run['seconds']:.2f} s "
          f"on the host, {rate:.4f} samples/s (guided stage 1 {run['stage1_s']:.2f} s, stage 2 "
          f"{sum(run['sampler_runs_s']):.2f} s); launches {run['launches']} (expected fused_conv_gn_mish "
          f"{expect}); " + ", ".join(f"{k} {np.round(rep[k]['mean'], 4).tolist()}"
                                     for k in sorted(EVAL_METRICS | KEYFRAME_METRICS)), flush=True)
    return dict(seconds=run["seconds"], samples_per_s=rate, launches=run["launches"],
                stage1_s=run["stage1_s"], sampler_runs_s=run["sampler_runs_s"], steps=steps,
                metrics={k: rep[k]["mean"] for k in sorted(EVAL_METRICS | KEYFRAME_METRICS)})


def plms_step_costs(prog):
    """(one replayed PLMS body step, the same step eagerly) on the program's buffers."""
    from condmdi_tpu_torch.diffusion.sampling import at_model_step, plms_step_body

    sched, buf = prog.pipe.sched, prog.buffers
    ti = sched.num_timesteps - 2
    graph, body = prog._graph(prog._branch(ti)), plms_step_body(prog.step, buf)

    def replayed():
        buf.t.fill_(ti)
        buf.coefs.copy_(prog.step.coefs(0))
        return graph(check=False)

    def eager():
        with at_model_step(sched.model_t_host(ti)):
            buf.t.fill_(ti)
            buf.coefs.copy_(prog.step.coefs(0))
            return body()

    return replayed, eager


def plms_phase28(dev, card):
    """PLMS (orders 2 and 4) and the DDIM reverse ODE on the gate checkpoint at
    conditional's shapes (4 samples, CFG 2.5, keyframes), over PLMS_STEPS respaced
    steps: graphs against eager bit for bit with the same launches, kernel against
    plain, samples/s and a step's host and device time; then the DDIM reverse ODE
    from a DDPM sample of the same model back to x_T, kernel against plain."""
    from condmdi_tpu_torch.diffusion import SamplerConfig
    from condmdi_tpu_torch.diffusion.sampling import ddim_reverse_sample_loop
    from condmdi_tpu_torch.sampling.conditional import parse_cli_args
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline
    from condmdi_tpu_torch.sampling.synthesize import load_model_for_sampling

    model, _, dcfg = load_model_for_sampling(parse_cli_args(GATE_CLI), dev)
    sched = schedule(PLMS_STEPS)
    B = CLI_SAMPLES
    text, obs, mask = (a.to(dev) for a in keyframe_inputs(B, 33))
    kw = dict(guidance_param=2.5, obs_x0=obs, obs_mask=mask, noise=seeded_noise((B, T_FRAMES, FEATS), dev, 34))
    y = {"text_embed": text}
    out = {}
    for order in PLMS_ORDERS:
        forwards = PLMS_STEPS + (1 if order > 1 else 0)
        row, xs, pipes = {}, {}, {}
        for name in ("graphs", "eager"):
            pipes[name] = SamplePipeline(model, sched, dcfg, SamplerConfig(method="plms",
                                         order=order), device=dev, cuda_graphs=name == "graphs")
            pipes[name].sample((B, T_FRAMES, FEATS), y, **kw)  # captures (or builds) first
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            xs[name] = pipes[name].sample((B, T_FRAMES, FEATS), y, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            row[name] = dict(seconds=seconds, rate=B / seconds, launches=read_counts(),
                             host_ms_per_step=seconds * 1e3 / PLMS_STEPS)
            if row[name]["launches"]["fused_conv_gn_mish"] != GATE_HALVES * forwards:
                raise SystemExit(f"PLMS order {order} ({name}): launches {row[name]['launches']}")
        (prog,) = pipes["graphs"].programs.values()
        replayed, eager = plms_step_costs(prog)
        row["graphs"].update(step_costs(replayed))
        row["eager"].update(step_costs(eager))
        for r in row.values():
            r["idle"] = 1.0 - r["device_ms"] / r["host_ms_per_step"]
        equal = torch.equal(xs["graphs"], xs["eager"])
        with resblock_swapped_for_plain():
            plain = pipes["graphs"].sample((B, T_FRAMES, FEATS), y, **kw)
        err = (xs["graphs"] - plain).abs().max().item()
        print(f"[plms] {card}: PLMS order {order}, gate UNet f32, {PLMS_STEPS} steps ({forwards} "
              f"forwards), CFG 2.5, B={B}: graphs {row['graphs']['rate']:.4f} samples/s, host "
              f"{row['graphs']['host_ms_per_step']:.4f} ms a step, device "
              f"{row['graphs']['device_ms']:.4f} ms, idle {row['graphs']['idle']:.1%}; eager "
              f"{row['eager']['rate']:.4f} samples/s, host {row['eager']['host_ms_per_step']:.4f} "
              f"ms a step, device {row['eager']['device_ms']:.4f} ms, idle "
              f"{row['eager']['idle']:.1%}; graph run equals eager run bit for bit: {equal}; "
              f"max|kernel - plain| {err:.3e} (tol {DDIM_TOL:.0e}), max|plain| "
              f"{plain.abs().max().item():.3f}; launches {row['graphs']['launches']}", flush=True)
        if not (equal and err <= DDIM_TOL and torch.isfinite(xs["graphs"]).all()):
            raise SystemExit(f"PLMS order {order}: graph/eager or kernel/plain disagree")
        out[f"order_{order}"] = dict(row, bit_equal=equal, max_abs_err=err)
    # DDIM reverse: a DDPM sample of the same model (guidance 1.0, no keyframe observed: an
    # empty mask, as the `uncond` edit mode gives it) back to x_T
    ddpm = SamplePipeline(model, sched, dcfg, SamplerConfig(), device=dev)
    free = torch.zeros_like(mask)
    x0 = ddpm.sample((B, T_FRAMES, FEATS), y, obs_x0=obs, obs_mask=free,
                     generator=torch.Generator(device=dev).manual_seed(35))
    denoise = ddpm.denoiser(y, 1.0, obs, free)
    reset_counts()
    t0 = time.perf_counter()
    got = ddim_reverse_sample_loop(denoise, sched.to(dev), dcfg, x0)
    torch.cuda.synchronize()
    seconds, launches = time.perf_counter() - t0, read_counts()
    with resblock_swapped_for_plain():
        want = ddim_reverse_sample_loop(denoise, sched.to(dev), dcfg, x0)
    # the reverse ODE amplifies: from |x_0| ~ 20 it reaches |x_T| ~ 50 on these random inputs,
    # and differences of one float32 rounding per call grow with it to ~5e-3 at elements of
    # any size; it is held relative to its output's scale, DDIM_TOL * max|plain|
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    print(f"[plms] {card}: DDIM reverse x_0 -> x_T of {B} DDPM-{PLMS_STEPS} samples (max|x_0| "
          f"{x0.abs().max().item():.3f}), {PLMS_STEPS} steps: max|kernel - plain| {err:.3e}, "
          f"max|kernel - plain| / max|plain| {rel:.3e} (tol {DDIM_TOL:.0e}), max|x_T| "
          f"{want.abs().max().item():.3f}, {seconds:.2f} s on the host; launches {launches}",
          flush=True)
    if not (rel <= DDIM_TOL and torch.isfinite(got).all()
            and launches["fused_conv_gn_mish"] == GATE_HALVES * PLMS_STEPS):
        raise SystemExit("DDIM reverse: the kernel path disagrees with the plain path")
    out["ddim_reverse"] = dict(max_abs_err=err, max_rel_err=rel, seconds=seconds,
                               launches=launches, max_abs_x_T=want.abs().max().item())
    return out


# --------------------------------------------------------------------------- #
# phases 29-33: action-to-motion and unconstrained generation, the model variants
# --------------------------------------------------------------------------- #
A2M_OUT = EVAL_OUT.parent / "a2m"  # never the default: save/ holds the JAX reports
A2M_BATCH, A2M_FRAMES, A2M_FEATS, A2M_STEPS, A2M_REPS = 32, 60, 150, 1000, 5
A2M_TOKENS = A2M_FRAMES + 1  # the frames and the action token
A2M_RUN = ["--eval_mode", "debug", "--diffusion_steps", str(A2M_STEPS), "--num_samples",
           str(A2M_BATCH), "--batch_size", str(A2M_BATCH), "--num_frames", str(A2M_FRAMES),
           "--seed", "10"]
# the MDM paper's action-to-motion width (ff 2 x latent, 4 heads: hd 128, route wgmma_f32),
# and the JAX CLIs' default width (hd 16: route stream, behind its pack pass)
A2M_PAPER = ["--latent_dim", "512", "--layers", "8"]
A2M_DEFAULT = ["--latent_dim", "64", "--layers", "2"]
A2M_ATTN_SHAPES = [("a2m_paper_width", A2M_BATCH, A2M_TOKENS, 512, 4),
                   ("a2m_cli_default", A2M_BATCH, A2M_TOKENS, 64, 4)]
# the committed JAX reports: the form the port's reports must have
A2M_REPORT = ROOT / "save" / "eval_out" / "eval_a2m_humanact12_debug.json"
UNCONSTRAINED_REPORT = ROOT / "save" / "eval_out" / "eval_unconstrained_debug.json"
GRU_STEPS = 100  # the GRU MDM's sample (8 layers x 60 steps of small products a forward)
XL_UNCONSTRAINED = ["--config", "motion_abs_unet_adagn_xl", "--keyframe_conditioned", "true",
                    "--unconstrained", "true", "--unet_attention", "true", "--batch_size", "64",
                    "--num_steps", "10", "--save_interval", "10"] + TRAIN_DATA


@contextlib.contextmanager
def one_replication():
    """evals.run_a2m and evals.run_unconstrained run one replication while open."""
    import condmdi_tpu_torch.evals.run_a2m as a2m_mod
    import condmdi_tpu_torch.evals.run_unconstrained as unc_mod

    saved = a2m_mod.EVAL_MODES, unc_mod.EVAL_MODES
    a2m_mod.EVAL_MODES = unc_mod.EVAL_MODES = {k: {**v, "replication_times": 1}
                                               for k, v in saved[0].items()}
    try:
        yield
    finally:
        a2m_mod.EVAL_MODES, unc_mod.EVAL_MODES = saved


def run_protocol(module, argv, label, clock=True):
    """evals.<module>.main on the card from the repository root, the counts set to 0
    just before it and read just after; every sampler run's output kept (and, with
    `clock`, its program and host seconds)."""
    import importlib

    import condmdi_tpu_torch.sampling.pipeline as pipeline_mod

    main = importlib.import_module(f"condmdi_tpu_torch.evals.{module}").main
    out = A2M_OUT / label
    record, samples = [], []

    with contextlib.chdir(ROOT), sampling_clock(record) if clock else contextlib.nullcontext():
        run = pipeline_mod.SamplingProgram.run  # the clock's, where it is open

        def kept(prog, *a, **kw):
            x = run(prog, *a, **kw)
            samples.append(x.detach().cpu().numpy())
            return x

        pipeline_mod.SamplingProgram.run = kept
        try:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            summary = main(argv + ["--output_dir", str(out)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counts()
        finally:
            pipeline_mod.SamplingProgram.run = run
    (path,) = out.glob("eval_*.json")
    return dict(summary=summary, report=json.loads(path.read_text()), report_name=path.name,
                seconds=seconds, launches=launches, record=record, samples=samples)


def check_protocol(run, label, committed, expect, reps=A2M_REPS):
    """The report in the committed JAX report's form (its metric keys, its meta keys
    among the port's), every mean and conf finite; each sampler run's output finite,
    [32, 60, 150]; the launches exact."""
    rep, want = run["report"], json.loads(committed.read_text())
    if set(rep) != set(want) or not set(want["meta"]) <= set(rep["meta"]):
        raise SystemExit(f"{label}: report keys {sorted(rep)} / meta {sorted(rep['meta'])} are "
                         f"not the committed report's {sorted(want)} / {sorted(want['meta'])}")
    values = [np.asarray(rep[k][s], np.float64) for k in want if k != "meta"
              for s in ("mean", "conf")]
    shapes = {x.shape for x in run["samples"]}
    if not all(np.isfinite(v).all() for v in values) or shapes != {
            (A2M_BATCH, A2M_FRAMES, A2M_FEATS)} or len(run["samples"]) != reps \
            or not all(np.isfinite(x).all() for x in run["samples"]):
        raise SystemExit(f"{label}: non-finite metrics or samples (shapes {shapes}, "
                         f"{len(run['samples'])} runs)")
    for kern, count in expect.items():
        if run["launches"][kern] != count:
            raise SystemExit(f"{label}: {kern} launches {run['launches'][kern]} != {count}")


def protocol_line(label, run, card, expect, steps=A2M_STEPS):
    """Print and return the run's rates and one step's host ms against device ms."""
    n = A2M_BATCH * len(run["samples"])
    sampling_s = sum(sec for _, sec in run["record"])
    replayed, _ = program_steps(run["record"][-1][0])
    costs = step_costs(replayed)
    host_ms = sampling_s * 1e3 / (steps * len(run["record"]))
    idle = 1.0 - costs["device_ms"] / host_ms
    metrics = {k: v["mean"] for k, v in run["summary"].items()}
    print(f"[a2m] {card}: {label}: {run['seconds']:.2f} s on the host for {n} samples, "
          f"{n / run['seconds']:.4f} samples/s ({n / sampling_s:.4f} over the sampler runs' "
          f"{sampling_s:.2f} s); host {host_ms:.4f} ms a step against device "
          f"{costs['device_ms']:.4f} ms (idle {idle:.1%}, {costs['launch_calls']:.1f} host "
          f"launch calls and {costs['device_ops']:.1f} device kernels and copies a step); "
          f"launches {run['launches']} (expected {expect}); "
          + ", ".join(f"{k} {np.round(v, 4).tolist()}" for k, v in metrics.items()), flush=True)
    return dict(seconds=run["seconds"], samples=n, samples_per_s=n / run["seconds"],
                sampling_s=sampling_s, sampling_samples_per_s=n / sampling_s,
                host_ms_per_step=host_ms, idle=idle, launches=run["launches"], metrics=metrics,
                report_name=run["report_name"], **costs)


def protocol_graphs(card, label, module, argv, per_step):
    """One replication through main with graphs and with cuda_graphs=False: the
    generated motions bit for bit, the same launches, rates and step costs both ways."""
    def run(name):
        with one_replication():
            r = run_protocol(module, argv, f"{label}_{name}", clock=False)
        return np.stack(r["samples"]), r["launches"]

    return graph_sampling_cli(card, f"{module} {label}, one replication", run, A2M_BATCH,
                              A2M_STEPS, {"fused_self_attention": per_step * A2M_STEPS})


def protocol_kernel_vs_plain(module, argv, label, per_step):
    """One replication through main at 20 DDPM steps through the kernel and with the
    plain attention in its place, the same seeds: the motions within DDIM_TOL."""
    argv = argv + ["--diffusion_steps", "20"]
    with one_replication():
        got = run_protocol(module, argv, label + "_kernel", clock=False)
        with attention_swapped_for_plain():
            want = run_protocol(module, argv, label + "_plain", clock=False)
    a, b = np.stack(got["samples"]), np.stack(want["samples"])
    err = float(np.abs(a - b).max())
    n = got["launches"]["fused_self_attention"], want["launches"]["fused_self_attention"]
    print(f"[a2m] {module} {label} DDPM-20 kernel against plain: max|kernel - plain| {err:.3e} "
          f"(tol {DDIM_TOL:.0e}), max|plain| {float(np.abs(b).max()):.3f}; attention launches "
          f"{n[0]} / {n[1]} (expected {per_step * 20} / 0)", flush=True)
    if not (np.isfinite(a).all() and err <= DDIM_TOL and np.abs(b).max() > 0):
        raise SystemExit(f"{module} {label}: the kernel path disagrees with the plain path")
    if n != (per_step * 20, 0):
        raise SystemExit(f"{module} {label}: attention launches {n}")
    return err


def a2m_routes():
    """The attention routes of the two a2m widths: wgmma_f32 at hd 128, stream at hd 16."""
    from condmdi_tpu_torch.ops.attention import attention_route

    routes = {name: attention_route(B, T, H, D // H, torch.float32)
              for name, B, T, D, H in A2M_ATTN_SHAPES}
    if routes != {"a2m_paper_width": "wgmma_f32", "a2m_cli_default": "stream"}:
        raise SystemExit(f"the a2m shapes take the routes {routes}")
    return routes


def a2m_phase29(dev, card):
    """evals.run_a2m through main on HumanAct12 (synthetic, 12 actions) at the MDM
    paper's width: 5 replications of one batch of 32, the 1000-step DDPM; graphs
    against eager on one replication; kernel against plain at 20 steps."""
    a2m_routes()
    per_step = 8  # one attention launch a layer
    run = run_protocol("run_a2m", A2M_RUN + A2M_PAPER, "humanact12")
    expect = {"fused_self_attention": per_step * A2M_STEPS * A2M_REPS, "fused_conv_gn_mish": 0}
    check_protocol(run, "run_a2m humanact12", A2M_REPORT, expect)
    out = dict(main=protocol_line("evals.run_a2m humanact12, MDM latent 512 x 8 layers, f32",
                                  run, card, expect))
    out["graphs"] = protocol_graphs(card, "humanact12", "run_a2m", A2M_RUN + A2M_PAPER, per_step)
    out["ddpm20_max_abs_err"] = protocol_kernel_vs_plain("run_a2m", A2M_RUN + A2M_PAPER,
                                                         "humanact12", per_step)
    return out


def a2m_phase30(dev, card):
    """evals.run_a2m --dataset uestc (40 actions, ST-GCN on the card) at the paper's
    width; then HumanAct12 at the CLIs' default widths (hd 16, the streaming route),
    with kernel against plain; the f32 attention at both a2m shapes per call, timed."""
    argv = A2M_RUN + A2M_PAPER + ["--dataset", "uestc"]
    run = run_protocol("run_a2m", argv, "uestc")
    expect = {"fused_self_attention": 8 * A2M_STEPS * A2M_REPS, "fused_conv_gn_mish": 0}
    check_protocol(run, "run_a2m uestc", A2M_REPORT, expect)
    if run["report"]["meta"]["dataset"] != "uestc":
        raise SystemExit("run_a2m --dataset uestc did not run UESTC")
    out = dict(uestc=protocol_line("evals.run_a2m uestc (ST-GCN), MDM latent 512 x 8 layers, f32",
                                   run, card, expect))
    run = run_protocol("run_a2m", A2M_RUN + A2M_DEFAULT, "humanact12_default")
    expect = {"fused_self_attention": 2 * A2M_STEPS * A2M_REPS, "fused_conv_gn_mish": 0}
    check_protocol(run, "run_a2m at the default widths", A2M_REPORT, expect)
    out["default"] = protocol_line("evals.run_a2m humanact12, MDM latent 64 x 2 layers (hd 16), "
                                   "f32", run, card, expect)
    out["default_ddpm20_max_abs_err"] = protocol_kernel_vs_plain(
        "run_a2m", A2M_RUN + A2M_DEFAULT, "humanact12_default", 2)
    out["attention_rows"] = f32_attention_rows(dev, A2M_ATTN_SHAPES)
    return out


def unconstrained_phase31(dev, card):
    """evals.run_unconstrained through main at phase 29's width: MDM no_cond, ST-GCN
    features, FID / KID / precision-recall / diversity over 5 replications."""
    run = run_protocol("run_unconstrained", A2M_RUN + A2M_PAPER, "unconstrained")
    expect = {"fused_self_attention": 8 * A2M_STEPS * A2M_REPS, "fused_conv_gn_mish": 0}
    check_protocol(run, "run_unconstrained", UNCONSTRAINED_REPORT, expect)
    return protocol_line("evals.run_unconstrained, MDM no_cond latent 512 x 8 layers, f32", run,
                         card, expect)


def variants_phase32(dev, card):
    """The model variants at full width, f32: MDM gru sampled through SamplePipeline
    with graphs and without (bit for bit); MDM trans_enc_large, one forward kernel
    against plain and DDIM-20; a UNet-XL action forward kernel against plain."""
    from condmdi_tpu_torch.models.mdm import MDM
    from condmdi_tpu_torch.models.unet import MDM_UNET

    B, shape = A2M_BATCH, (A2M_BATCH, A2M_FRAMES, A2M_FEATS)
    y = {"action": torch.arange(B, device=dev) % 12}
    a2m_mdm = dict(njoints=25, nfeats=6, latent_dim=512, ff_size=1024, num_layers=8, num_heads=4,
                   cond_mode="action", num_actions=12, device=dev, seed=0)
    gru = MDM(arch="gru", **a2m_mdm).eval()
    runs, outs, progs = {}, {}, {}
    for name in ("graphs", "eager"):
        record = []
        with graphs_off() if name == "eager" else contextlib.nullcontext(), \
                sampling_clock(record):
            pipe = pipeline(lambda x, t, y_, **_: gru(x, t, y_), schedule(GRU_STEPS), dev)
            reset_counts()
            outs[name] = pipe.sample(shape, y, generator=torch.Generator(dev).manual_seed(3))
            torch.cuda.synchronize()
            launches = read_counts()
        (progs[name], seconds), = record
        runs[name] = dict(rate=B / seconds, sampling_s=seconds,
                          host_ms_per_step=seconds * 1e3 / GRU_STEPS, launches=launches)
    if not torch.isfinite(outs["graphs"]).all() or any(runs["graphs"]["launches"].values()):
        raise SystemExit(f"MDM gru: non-finite sample or kernel launches "
                         f"{runs['graphs']['launches']}")
    replayed, eager = program_steps(progs["graphs"])
    runs["graphs"].update(step_costs(replayed))
    # eager, a step launches ~5,900 kernels, more than the launch queue holds: its device
    # time is the profiler's kernel time
    runs["eager"].update(step_costs(eager, profiler_time=True))
    out = dict(gru=graph_row(f"MDM gru (latent 512, 8 layers) B={B}, {GRU_STEPS}-step DDPM",
                             "samples/s", runs, torch.equal(outs["graphs"], outs["eager"]), card))
    del gru, pipe, progs, outs

    def forward_vs_plain(label, model, x, t, y, kernel, per_forward, swap, tol):
        with torch.no_grad():
            reset_counts()
            got = model(x, t, y)
            torch.cuda.synchronize()
            launches = read_counts()[kernel]
            with swap():
                want = model(x, t, y)
        err = (got - want).abs()
        if tol == "f32":
            bad = int((err > F32_TOL * (1 + want.abs())).sum().item())
            held = f"{bad} outside {F32_TOL:.0e}*(1+|plain|)"
        else:
            bad = int(err.max().item() > DDIM_TOL)
            held = f"tol {DDIM_TOL:.0e}"
        print(f"[variants] {label}: max|kernel - plain| = {err.max().item():.3e} ({held}), "
              f"max|plain| = {want.abs().max().item():.3f}; {kernel} launches {launches} "
              f"(expected {per_forward})", flush=True)
        if bad or not torch.isfinite(got).all() or want.abs().max() == 0 \
                or launches != per_forward:
            raise SystemExit(f"{label}: the kernel path disagrees with the plain path")
        return err.max().item()

    x = seeded_noise(shape, dev, seed=41)
    t = torch.arange(B, device=dev) * 31
    large = MDM(arch="trans_enc_large", **a2m_mdm).eval()
    out["large_forward_max_abs_err"] = forward_vs_plain(
        f"MDM trans_enc_large f32 forward B={B}", large, x, t, y, "fused_self_attention", 8,
        attention_swapped_for_plain, "f32")
    pipe = pipeline(lambda x_, t_, y_, **_: large(x_, t_, y_), schedule(20), dev, method="ddim")
    noise = seeded_noise(shape, dev, seed=42)
    out["large_ddim20_max_abs_err"] = kernel_vs_plain(
        "variants", f"MDM trans_enc_large f32 DDIM-20 B={B}",
        lambda: pipe.sample(shape, y, noise=noise), attention_swapped_for_plain)
    del large, pipe
    xl = MDM_UNET(njoints=25, nfeats=6, latent_dim=512, dim_mults=(2, 2, 2, 2), zero=False,
                  cond_mode="action", num_actions=12, pad_frames_to=64, device=dev, seed=0).eval()
    out["xl_action_forward_max_abs_err"] = forward_vs_plain(
        "UNet-XL action (150 features, pad 64) f32 forward B=8", xl, x[:8], t[:8],
        {"action": y["action"][:8]}, "fused_conv_gn_mish", 33, resblock_swapped_for_plain, "ddim")
    return out


def unconstrained_phase33(dev, card):
    """UNet-XL unconstrained (no_cond) with LinearAttention trained through main (B=64,
    10 steps, synthetic set): exact launches, finite losses, steps/s; the f32 halves at
    B=64; conditional from the step-10 EMA (2 samples, the 1000-step DDPM); one step
    through the kernels against the plain path, as phase 23."""
    import shutil

    out_dir = TRAIN_OUT / "xl_unconstrained"
    shutil.rmtree(out_dir, ignore_errors=True)
    loop, seconds, launches = run_train(XL_UNCONSTRAINED, out_dir,
                                        "UNet-XL unconstrained + LinearAttention 10 steps",
                                        ("fused_conv_gn_mish", 10 * XL_TRAIN_HALVES))
    model = loop.model
    if not (model.cond_mode == "no_cond" and model.unet.attention
            and not hasattr(model, "embed_text")):
        raise SystemExit("the unconstrained attention UNet was not built as asked")
    rows = progress_rows(out_dir)
    losses = [r["loss"] for r in rows]
    sps = steps_per_second(rows, 3)
    if not (np.isfinite(losses).all() and len(losses) == 10):
        raise SystemExit(f"UNet-XL unconstrained training: losses {losses}")
    print(f"[train] UNet-XL unconstrained + LinearAttention B=64 pad 224: {sps:.3f} steps/s "
          f"(steps 3-9 over their host time), loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{seconds:.2f} s in all [{card}]", flush=True)
    argv = ["--model_path", str(out_dir / "ema_000000010.npz"), "--edit_mode", "benchmark_sparse",
            "--num_samples", "2", "--num_repetitions", "1"]
    res, cli_s, cli_launches = run_cli("conditional", argv, "unconstrained_xl_ema10")
    # the JAX CLI's keys, finite (the EMA of 10 steps from zero output convs may sample
    # a nearly constant motion, so its spread is not asked for)
    if set(res) != CLI_KEYS["conditional"] or res["motion"].shape != (2, T_FRAMES, FEATS) \
            or not all(np.isfinite(res[k]).all() for k in ("motion", "joints")):
        raise SystemExit(f"conditional on the unconstrained EMA: keys {sorted(res)}, motion "
                         f"{res['motion'].shape}")
    print(f"[train] conditional on the unconstrained step-10 EMA (1000-step DDPM, 2 samples): "
          f"{cli_s:.2f} s, {2 / cli_s:.4f} samples/s; launches {cli_launches} (expected "
          f"fused_conv_gn_mish {CLI_STEPS * XL_TRAIN_HALVES})", flush=True)
    if cli_launches["fused_conv_gn_mish"] != CLI_STEPS * XL_TRAIN_HALVES:
        raise SystemExit("conditional on the unconstrained EMA: wrong launch count")
    drop_checkpoints(out_dir)
    shapes = record_resblock_shapes(model, *train_forward_inputs(loop))
    if sum(shapes.values()) != XL_TRAIN_HALVES:
        raise SystemExit(f"expected {XL_TRAIN_HALVES} halves in a training forward: {shapes}")
    rows_b64 = f32_resblock_rows("UNet-XL unconstrained + LinearAttention training pad 224",
                                 shapes, 64, dev)
    pair = train_step_pair(loop, resblock_swapped_for_plain, "xl",
                           "UNet-XL unconstrained + LinearAttention")
    del loop, model
    return dict(launches=launches["fused_conv_gn_mish"], seconds=seconds, steps_per_sec=sps,
                loss_first=losses[0], loss_last=losses[-1], resblock_rows=rows_b64,
                conditional=dict(seconds=cli_s, samples_per_s=2 / cli_s, launches=cli_launches),
                step_pair=pair)


# --------------------------------------------------------------------------- #
# phases 34-39: SMPL, joints2smpl, AMASS, the file-backed datasets, evals.parity,
# parallel/ (all in float32, TF32 off)
# --------------------------------------------------------------------------- #
WORK = ROOT / ".chipwork"  # written and read here, not brought back (too large)
SMPL_VERTICES = 6890  # SMPL's vertex count
SMPL_TRAIN_STEPS = 3
AMASS = dict(njoints=764, latent_dim=512, dim_mults=(2, 2, 2, 2), keyframe_conditioned=True,
             pad_frames_to=128, cond_mode="no_cond")
AMASS_BATCH, AMASS_FRAMES, AMASS_STEPS = 8, 128, 1000
FILE_TRAIN_STEPS = 5
PARITY_STEPS = 50  # the mock checkpoint's diffusion steps (the released model has 1000)
TP_FORWARD_TOL = 1e-4  # |tp - plain| <= tol * (1 + |plain|): the row layers add their bias apart


def smpl_phase34(dev, card):
    """training_losses with the SMPL terms (rcxyz, fc; get_xyz a Rotation2xyz over a
    6890-vertex synthetic body) on the action MDM at the a2m width, B=32, 60 frames,
    dropout on: one step through the attention kernel against the plain path (loss,
    every gradient), then SMPL_TRAIN_STEPS AdamW steps with exact launches, timed: host
    enqueue and wall ms a step, and the profiler's device ms a step."""
    from condmdi_tpu_torch.data.a2m import SyntheticA2MDataset
    from condmdi_tpu_torch.diffusion import DiffusionConfig
    from condmdi_tpu_torch.diffusion.gaussian import training_losses
    from condmdi_tpu_torch.models.layers import TrainDraws
    from condmdi_tpu_torch.models.mdm import MDM as MDMModel
    from condmdi_tpu_torch.models.smpl import Rotation2xyz, SMPLModel, SMPLWrapper
    from condmdi_tpu_torch.training.loop import (TrainConfig, clip_by_global_norm_, global_norm,
                                                 make_optimizer)

    B, T = A2M_BATCH, A2M_FRAMES
    ds = SyntheticA2MDataset(size=B, num_frames=T, seed=0)
    x0 = torch.from_numpy(np.stack([ds[i]["motion"] for i in range(B)])).to(dev)
    y = {"action": torch.tensor([ds[i]["action"] for i in range(B)], device=dev)}
    time_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    body = SMPLModel.random_init(n_vertices=SMPL_VERTICES, seed=0, device=dev)
    to_xyz = Rotation2xyz(SMPLWrapper(body))

    def get_xyz(x):
        return to_xyz(x.reshape(x.shape[0], x.shape[1], 25, 6), pose_rep="rot6d")

    sched = schedule(1000).to(dev)
    dcfg = DiffusionConfig(lambda_rcxyz=1.0, lambda_fc=1.0)
    model = MDMModel(njoints=25, nfeats=6, latent_dim=512, ff_size=1024, num_layers=8,
                     num_heads=4, cond_mode="action", num_actions=12, device=dev, seed=0).train()
    tcfg = TrainConfig(lr=1e-4)
    opt = make_optimizer(model.parameters(), tcfg)
    params = list(model.parameters())

    def step(gen):
        t = torch.randint(0, 1000, (B,), generator=gen, device=dev)
        noise = torch.randn(x0.shape, generator=gen, device=dev)
        draws = TrainDraws(gen)
        terms = training_losses(lambda x, tm: model(x, tm, y, draws=draws), sched, dcfg, x0, t,
                                noise, time_mask, get_xyz=get_xyz)
        loss = terms["loss"].mean()
        opt.zero_grad()
        loss.backward()
        with torch.no_grad():
            grads = [p.grad for p in params]
            clip_by_global_norm_(grads, tcfg.grad_clip, global_norm(grads))
            opt.step()
        return loss.detach(), terms

    # kernel against plain: one step from the same weights and draws, before the optimizer
    start = {k: v.clone() for k, v in model.state_dict().items()}
    pair = []
    for swap in (contextlib.nullcontext, attention_swapped_for_plain):
        model.load_state_dict(start)
        gen = torch.Generator(dev).manual_seed(3)
        with swap():
            t = torch.randint(0, 1000, (B,), generator=gen, device=dev)
            noise = torch.randn(x0.shape, generator=gen, device=dev)
            draws = TrainDraws(gen)
            terms = training_losses(lambda x, tm: model(x, tm, y, draws=draws), sched, dcfg, x0,
                                    t, noise, time_mask, get_xyz=get_xyz)
            model.zero_grad()
            terms["loss"].mean().backward()
        pair.append(dict(loss=float(terms["loss"].mean().detach()), terms={k: float(v.detach().mean())
                                                                  for k, v in terms.items()},
                         grads=parameter_leaves({k: p.grad.clone() for k, p in
                                                 model.named_parameters()}, "mdm")))
    k, p = pair
    if not {"rcxyz_mse", "fc"} <= set(k["terms"]):
        raise SystemExit(f"SMPL loss terms missing: {sorted(k['terms'])}")
    loss_err = abs(k["loss"] - p["loss"])
    g_errs = {n: float((k["grads"][n] - p["grads"][n]).norm()
                       / p["grads"][n].norm().clamp(min=1e-30))
              for n in p["grads"] if not n.endswith("[k]")}
    worst = max(g_errs.items(), key=lambda kv: kv[1])
    print(f"[smpl] MDM a2m width B={B} T={T} with rcxyz and fc over a {SMPL_VERTICES}-vertex body, "
          f"one step kernel against plain: loss {k['loss']:.6f} vs {p['loss']:.6f} (|diff| "
          f"{loss_err:.2e}, tol {TRAIN_LOSS_TOL:.0e} x (1+|plain|)); terms {k['terms']}; "
          f"gradients |diff|/|plain| at most {worst[1]:.2e} ({worst[0]}, tol "
          f"{TRAIN_GRAD_TOL:.0e}, {len(g_errs)} tensors)", flush=True)
    if loss_err > TRAIN_LOSS_TOL * (1 + abs(p["loss"])) or worst[1] > TRAIN_GRAD_TOL \
            or not np.isfinite(k["loss"]):
        raise SystemExit("SMPL-loss step: the kernel path disagrees with the plain path")
    model.load_state_dict(start)
    del start, pair

    gen = torch.Generator(dev).manual_seed(4)
    losses, host, wall = [], [], []
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(SMPL_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, _ = step(gen)
        host.append((time.perf_counter() - t0) * 1e3)  # the host's enqueue of the step
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = read_counts()
    # the step launches more kernels than the launch queue holds, so its device time is
    # the profiler's kernel time (two more steps, not counted above)
    costs = step_costs(lambda: step(gen), profiler_time=True, n=2)
    expect = 8 * SMPL_TRAIN_STEPS
    print(f"[smpl] {SMPL_TRAIN_STEPS} AdamW steps: losses {[round(v, 5) for v in losses]}, host "
          f"ms a step {[round(v, 2) for v in host]}, wall ms {[round(v, 2) for v in wall]}; a "
          f"step's device time "
          + (f"{costs['device_ms']:.3f} ms (profiler)" if costs["device_ms"] else "not measured")
          + f", "
          f"{costs['launch_calls']:.0f} launch calls; attention launches "
          f"{launches['fused_self_attention']} (expected {expect}) [{card}]", flush=True)
    if launches["fused_self_attention"] != expect or not np.isfinite(losses).all():
        raise SystemExit("SMPL-loss training: wrong launch count or a non-finite loss")
    del model, opt
    return dict(loss_abs_err=loss_err, grad_max_rel_err=worst[1], grad_worst=worst[0],
                terms_kernel=k["terms"], losses=losses, host_ms=host, wall_ms=wall,
                launches=launches["fused_self_attention"], **costs)


def joints2smpl_phase35(dev, card):
    """render_mesh_cli on sample 0 of phase 15's gate conditional results.npy (196
    frames) over a 6890-vertex synthetic body, FitConfig's 300 Adam steps replayed from
    a CUDA graph; the same fit eagerly, bit for bit; the loss drop; the .obj files."""
    import shutil

    from condmdi_tpu_torch.models.smpl import SMPLModel
    from condmdi_tpu_torch.viz.joints2smpl import (FitConfig, fit_loss, fit_smpl_to_joints,
                                                   render_mesh_cli)

    results = CLI_OUT / "gate" / "results.npy"
    joints = np.load(results, allow_pickle=True).item()["joints"][0]
    body = SMPLModel.random_init(n_vertices=SMPL_VERTICES, seed=0, device=dev)
    target = torch.from_numpy(np.asarray(joints, np.float32)).to(dev)
    cfg = FitConfig()
    T = target.shape[0]
    with torch.no_grad():
        start = float(fit_loss(body, target, {"pose": torch.zeros((T, 24, 3), device=dev),
                                              "trans": target[:, 0],
                                              "betas": torch.zeros(10, device=dev)}, cfg))
    fits, secs = {}, {}
    for name, graphs in (("graphs", True), ("eager", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits[name] = fit_smpl_to_joints(body, target, cfg, cuda_graphs=graphs)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    (pg, lg), (pe, le) = fits["graphs"], fits["eager"]
    equal = torch.equal(lg, le) and all(torch.equal(pg[k], pe[k]) for k in pg)
    out = WORK / "joints2smpl"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    paths, loss = render_mesh_cli(str(results), str(out), 0, model=body)
    cli_s = time.perf_counter() - t0
    lines = paths[0].read_text().splitlines()
    print(f"[joints2smpl] {T} frames, {cfg.num_steps} Adam steps over a {SMPL_VERTICES}-vertex body: "
          f"loss {start:.5f} -> {float(lg):.5f}; graph-replayed fit {secs['graphs']:.2f} s, eager "
          f"{secs['eager']:.2f} s, equal bit for bit: {equal}; render_mesh_cli {cli_s:.2f} s, "
          f"{len(paths)} .obj files of {len(lines)} vertices, loss {loss:.5f} [{card}]",
          flush=True)
    if not (equal and float(lg) < start and len(paths) == T and len(lines) == SMPL_VERTICES
            and abs(loss - float(lg)) <= 1e-6 * (1 + abs(loss)) and np.isfinite(loss)):
        raise SystemExit("joints2smpl: the replayed fit differs from the eager one, or the fit "
                         "did not lower the loss, or the mesh files are wrong")
    return dict(frames=T, loss_start=start, loss_end=float(lg), graph_s=secs["graphs"],
                eager_s=secs["eager"], graph_equals_eager=equal, render_s=cli_s,
                obj_files=len(paths))


def amass_phase36(dev, card):
    """UNet-XL with AMASS's 764 features, keyframe-conditioned (first half Cin 1528),
    pad 128, B=8 (no text: no CFG): SyntheticAMASSDataset clips under a joint-level
    keyframe mask expanded by amass_joint_to_full_mask, the 1000-step DDPM replayed
    from graphs with exact launches; DDIM-20 kernel against plain; every resblock shape
    per call against plain (f32 timed, the new first-half shape also in bf16 at B = 8,
    1, 3); fields_from_poses and dict_to_xyz on the card against the CPU."""
    from condmdi_tpu_torch.data.amass import SyntheticAMASSDataset, amass_joint_to_full_mask
    from condmdi_tpu_torch.data.amass_fk import ForwardKinematics, dict_to_xyz, fields_from_poses
    from condmdi_tpu_torch.models.unet import MDM_UNET

    B, T = AMASS_BATCH, AMASS_FRAMES
    model = perturbed(MDM_UNET(**AMASS, zero=False, device=dev, seed=0), dev, torch.float32)
    ds = SyntheticAMASSDataset(size=B, seed=0)
    obs = torch.from_numpy(np.stack([ds[i]["motion"] for i in range(B)])).to(dev)
    joint_mask = np.zeros((B, T, 24), bool)
    joint_mask[:, ::16] = True  # every 16th frame whole
    joint_mask[:, 8::16, :4] = True  # and the root and hips between them
    mask = torch.from_numpy(amass_joint_to_full_mask(joint_mask)).to(dev)
    shape = (B, T, 764)

    pipe = pipeline(model, schedule(AMASS_STEPS), dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sample = pipe.sample(shape, {}, obs_x0=obs, obs_mask=mask,
                         generator=torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()["fused_conv_gn_mish"]
    expect = 33 * AMASS_STEPS
    print(f"[amass] UNet-XL 764 features, keyframes ({int(mask.sum())} observed entries), "
          f"{AMASS_STEPS}-step DDPM B={B} from graphs: {seconds:.2f} s, {B / seconds:.3f} "
          f"samples/s; resblock launches {launches} (expected {expect}) [{card}]", flush=True)
    if launches != expect or not torch.isfinite(sample).all():
        raise SystemExit("AMASS sampling: wrong launch count or non-finite samples")
    noise = seeded_noise(shape, dev, seed=9)
    ddim = pipeline(model, schedule(20), dev, method="ddim")
    err = kernel_vs_plain("amass", f"UNet-XL amass f32 DDIM-20 B={B}",
                          lambda: ddim.sample(shape, {}, obs_x0=obs, obs_mask=mask, noise=noise),
                          resblock_swapped_for_plain)

    shapes = record_resblock_shapes(model, noise, torch.full((B,), 500, device=dev), {},
                                    dict(obs_x0=obs, obs_mask=mask))
    if sum(shapes.values()) != 33 or not any(k[0] == 1528 for k in shapes):
        raise SystemExit(f"AMASS UNet: expected 33 halves with a Cin-1528 first one: {shapes}")
    gen = torch.Generator().manual_seed(41)
    first = next(k for k in shapes if k[0] == 1528)
    bf16_err = max(kernel_against_plain(b, first[2], 1528, first[1], first[3], first[4], first[5],
                                        torch.bfloat16, BF16_TOL, gen, dev) for b in (B, 1, 3))
    rows = f32_resblock_rows("UNet-XL amass pad 128", shapes, B, dev)
    first_row = next(r for r in rows["rows"] if r["cin"] == 1528)

    # the 764-d fields on the card against the CPU
    rng = np.random.default_rng(2)
    poses = np.cumsum(0.05 * rng.standard_normal((B, T, 24, 3)), axis=1).astype(np.float32)
    trans = np.cumsum(0.02 * rng.standard_normal((B, T, 3)), axis=1).astype(np.float32)
    fk = ForwardKinematics()
    got = fields_from_poses(torch.from_numpy(poses).to(dev), torch.from_numpy(trans).to(dev), fk)
    want = fields_from_poses(torch.from_numpy(poses), torch.from_numpy(trans), fk)
    height = torch.from_numpy(rng.standard_normal((B, T, 24)).astype(np.float32))
    xyz_got = dict_to_xyz(dict(got, height=height.to(dev)))
    xyz_want = dict_to_xyz(dict(want, height=height))
    field_err = max(float((got[k].cpu() - want[k]).abs().max() / (1 + want[k].abs().max()))
                    for k in want)
    xyz_err = float((xyz_got.cpu() - xyz_want).abs().max())
    print(f"[amass] fields_from_poses B={B} T={T} on the card against the CPU: max relative "
          f"difference {field_err:.2e}; dict_to_xyz {xyz_err:.2e} (tol 1e-4)", flush=True)
    if field_err > 1e-4 or xyz_err > 1e-4 * (1 + float(xyz_want.abs().max())):
        raise SystemExit("AMASS fields: the card disagrees with the CPU")
    del model, pipe, ddim
    return dict(launches=launches, seconds=seconds, samples_per_s=B / seconds,
                ddim20_max_abs_err=err, first_half_bf16_max_abs_err=bf16_err,
                resblock_rows=rows, first_half=first_row, fields_max_rel_err=field_err,
                xyz_max_abs_err=xyz_err)


def write_text2motion_tree(root: Path, n: int, frames: int, dev, kit=False) -> Path:
    """A HumanML3D (263 features, abs-root and relative) or KIT (251, random) tree of
    n clips with a base caption and a tagged sub-clip each, and its train split."""
    from condmdi_tpu_torch.data import dataset as tds

    texts = root / "texts"
    texts.mkdir(parents=True, exist_ok=True)
    names = [f"{i:06d}" for i in range(n)]
    if kit:
        rng = np.random.default_rng(5)
        sets = {"new_joint_vecs": rng.standard_normal((n, frames, 251)).astype(np.float32)}
    else:
        sets = {sub: tds.SyntheticMotionDataset._make_items(
            tds.DatasetConfig(abs_3d=abs_3d), 4, n, frames + 1, dev)[0]
            for abs_3d, sub in ((False, "new_joint_vecs"), (True, "new_joint_vecs_abs_3d"))}
    for sub, feats in sets.items():
        (root / sub).mkdir(exist_ok=True)
        for name, f in zip(names, feats):
            np.save(root / sub / f"{name}.npy", f)
    for name in names:
        (texts / f"{name}.txt").write_text(
            "a person walks forward#a/DET person/NOUN walk/VERB forward/ADV#0.0#0.0\n"
            "a person stops#a/DET person/NOUN stop/VERB#1.0#3.5\n")
    (root / "train.txt").write_text("\n".join(names) + "\n")
    return root


def datasets_phase37(dev, card):
    """The file-backed datasets: a HumanML3D tree and a KIT tree written here from
    the synthetic set (tagged captions); training.train through main on the
    HumanML3D tree (UNet-XL keyframe card, B=16, FILE_TRAIN_STEPS steps) with
    --use_random_proj true --augment_type full, exact launches; a KIT batch."""
    import shutil

    from condmdi_tpu_torch.data.dataset import (DatasetConfig, Text2MotionDataset, collate)

    root = WORK / "text2motion"
    shutil.rmtree(root, ignore_errors=True)
    hml = write_text2motion_tree(root / "HumanML3D", 40, 120, dev)
    kit = write_text2motion_tree(root / "KIT-ML", 12, 80, dev, kit=True)
    kit_ds = Text2MotionDataset(DatasetConfig(name="kit", data_dir=str(kit), split="train"))
    np.random.seed(0)
    kit_batch = collate([kit_ds[i] for i in range(8)], 196)
    argv = ["--config", "motion_abs_unet_adagn_xl", "--keyframe_conditioned", "true",
            "--batch_size", "16", "--num_steps", str(FILE_TRAIN_STEPS), "--save_interval", "100",
            "--log_interval", "1", "--data_dir", str(hml), "--use_random_proj", "true",
            "--augment_type", "full", "--text_encoder", "hash", "--seed", "10"]
    out_dir = TRAIN_OUT / "humanml_files"
    shutil.rmtree(out_dir, ignore_errors=True)
    loop, seconds, launches = run_train(argv, out_dir, "UNet-XL on the HumanML3D tree",
                                        ("fused_conv_gn_mish", 33 * FILE_TRAIN_STEPS))
    ds = loop.data_loader.dataset
    losses = [r["loss"] for r in progress_rows(out_dir)]
    tagged = sum(e["span"] is not None for e in ds.entries)
    print(f"[data] HumanML3D tree: {len(ds)} entries ({tagged} tagged sub-clips), random "
          f"projection {ds.rand_proj is not None}, augment {ds.cfg.augment_type}; "
          f"{FILE_TRAIN_STEPS} steps in {seconds:.2f} s, losses {[round(v, 4) for v in losses]}; "
          f"KIT tree: {len(kit_ds)} entries, a batch {kit_batch['motion'].shape} [{card}]",
          flush=True)
    if not (isinstance(ds, Text2MotionDataset) and ds.rand_proj is not None and tagged == 40
            and len(losses) == FILE_TRAIN_STEPS and np.isfinite(losses).all()
            and kit_batch["motion"].shape == (8, 196, 251)):
        raise SystemExit("file-backed datasets: the run did not read the tree as asked")
    drop_checkpoints(out_dir)
    del loop
    return dict(entries=len(ds), tagged=tagged, launches=launches["fused_conv_gn_mish"],
                seconds=seconds, losses=losses, kit_entries=len(kit_ds))


def parity_phase38(dev, card):
    """evals.parity through its main on mock assets written here (GloVe over a few
    words, a T2M evaluator at its real widths, a HumanML3D tree of 36 clips, a
    released-layout model000750000.pt from random UNet-XL weights, keyframe and text
    conditioned, with PARITY_STEPS diffusion steps in its args.json): one replication
    of one batch of 32 under CFG 2.5; the verdict blocked_expected with the template's
    nulls; exact launches."""
    import os
    import shutil

    from condmdi_tpu_torch.evals import parity
    from condmdi_tpu_torch.models.unet import MDM_UNET

    root = WORK / "parity"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    write_mock_evaluator_assets(root)
    write_mock_humanml(root, device=dev)
    model = perturbed(MDM_UNET(**{**XL, "pad_frames_to": 224}, zero=False, device=dev, seed=0),
                      dev, torch.float32)
    write_reference_checkpoint(
        root / "save" / "condmdi_randomframes" / "model000750000.pt", model,
        dict(arch="unet", latent_dim=XL["latent_dim"], dim_mults=list(XL["dim_mults"]),
             diffusion_steps=PARITY_STEPS,
             keyframe_conditioned=True, abs_3d=True, num_frames=T_FRAMES, unet_adagn=True,
             unet_zero=False, unet_pad_to=224))
    del model
    cwd = os.getcwd()
    os.chdir(root)
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = parity.main(["--num_samples", "32", "--max_replications", "1",
                           "--output_dir", str(EVAL_OUT / "parity")], device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()["fused_conv_gn_mish"]
    finally:
        os.chdir(cwd)
    expect = 33 * PARITY_STEPS
    print(f"[parity] evals.parity on mock assets: verdict {out['status']}, rows "
          f"{[(r[0], round(r[1], 4), r[2]) for r in out.get('rows', [])]}; {seconds:.2f} s; "
          f"resblock launches {launches} (expected {expect}) [{card}]", flush=True)
    if out["status"] != "blocked_expected" or launches != expect or \
            any(r[2] is not None or not np.isfinite(r[1]) for r in out["rows"]):
        raise SystemExit("evals.parity on mocks: wrong verdict, rows or launch count")
    return dict(status=out["status"], rows=[list(r) for r in out["rows"]], seconds=seconds,
                launches=launches)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_phase39(dev, card):
    """parallel/ at world size 1 on NCCL (one card shows no more): generate_eval_batch
    with a 1-rank mesh against the call without (UNet-XL, B=8, CFG 2.5, a 20-step DDPM
    from graphs) bit for bit; a data-parallel train step (BufferedTrainStep: two graphs,
    the all-reduce between them on the host) against the plain step replayed from its
    graph, 8 steps, bit for bit, and the replayed steps' wall ms;
    the tensor-parallel forward on a 1x1 mesh against the plain forward (UNet-XL and
    MDM, within TP_FORWARD_TOL), with their launches."""
    import torch.distributed as dist

    from condmdi_tpu_torch.data.dataset import DatasetConfig, SyntheticMotionDataset, collate
    from condmdi_tpu_torch.diffusion import DiffusionConfig
    from condmdi_tpu_torch.evals.harness import EvalConfig, generate_eval_batch
    from condmdi_tpu_torch.models.text import HashTextEncoder
    from condmdi_tpu_torch.models.unet import MDM_UNET
    from condmdi_tpu_torch.parallel import (initialize_distributed, make_mesh, make_mesh_2d,
                                            tensor_parallel)
    from condmdi_tpu_torch.training.loop import (StepDraws, TrainConfig, create_train_state,
                                                 make_train_step)

    initialize_distributed(init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                           backend="nccl")
    out = {}
    try:
        mesh = make_mesh()
        B = 8
        model = build_xl(dev, torch.float32)
        pipe = pipeline(model, schedule(20), dev)
        rel = SyntheticMotionDataset(DatasetConfig(max_motion_length=T_FRAMES, abs_3d=False),
                                     size=B, seed=1, device=dev)
        ab = SyntheticMotionDataset(DatasetConfig(max_motion_length=T_FRAMES, abs_3d=True),
                                    size=B, seed=1, device=dev)
        np.random.seed(0)
        batch = collate([rel[i] for i in range(B)], T_FRAMES, HashTextEncoder())
        cfg = EvalConfig(guidance_param=GUIDANCE, max_frames=T_FRAMES, batch_size=B)
        gens, counts = [], []
        for m in (None, mesh):
            reset_counts()
            gens.append(generate_eval_batch(pipe, batch, 3, cfg, ab.stats, rel.stats, mesh=m))
            torch.cuda.synchronize()
            counts.append(read_counts()["fused_conv_gn_mish"])
        same = all(np.array_equal(getattr(gens[0], f), getattr(gens[1], f))
                   for f in ("motions_rel", "dist_error", "keyframe_error", "skate_ratio",
                             "num_keyframes"))
        print(f"[parallel] NCCL world size 1: generate_eval_batch (UNet-XL B={B}, CFG "
              f"{GUIDANCE}, 20-step DDPM) with a 1-rank mesh equals it without, bit for bit: "
              f"{same}; resblock launches {counts} (expected {33 * 20} each)", flush=True)
        if not same or counts != [33 * 20, 33 * 20]:
            raise SystemExit("data-parallel generation at world size 1 differs from the plain run")
        out["generate_eval_batch_bit_exact"] = same
        del pipe

        # the train step
        sched = schedule(1000).to(dev)
        tcfg = TrainConfig(lr=1e-4, keyframe_conditioned=True)
        motion = torch.from_numpy(batch["motion"]).to(dev)
        tb = {"motion": motion, "time_mask": torch.from_numpy(batch["time_mask"]).to(dev),
              "lengths": torch.from_numpy(batch["lengths"]).long().to(dev),
              "lengths_host": torch.from_numpy(batch["lengths"]).long(),
              "text_embed": torch.from_numpy(batch["text_embed"]).to(dev)}
        runs, step_counts, graph_counts, replay_ms = [], [], [], []
        n_steps = 8  # eager, captured, replayed 6 times
        with deterministic_cudnn():
            for m in (None, mesh):
                net = MDM_UNET(**XL, zero=False, device=dev, seed=0).train()
                state = create_train_state(net, tcfg, sched)
                step = make_train_step(net, sched, DiffusionConfig(), tcfg, mesh=m)
                draws = StepDraws(torch.Generator(dev).manual_seed(5),
                                  torch.Generator().manual_seed(6))
                reset_counts()
                losses, ms = [], []
                for _ in range(n_steps):
                    t0 = time.perf_counter()
                    losses.append(float(step(state, tb, draws)["loss"]))  # a sync a step
                    ms.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                replay_ms.append(float(np.mean(ms[2:])))
                step_counts.append(read_counts()["fused_conv_gn_mish"])
                graphs = [g for g in (step.graph, getattr(step, "update_graph", None)) if g]
                graph_counts.append([(g.captures, g.replays) for g in graphs])
                runs.append((losses, {k: v.detach().clone() for k, v in state.params.items()},
                             {k: v.clone() for k, v in state.ema.items()}, type(step).__name__))
                del net, state, step, graphs
        exact = runs[0][0] == runs[1][0] and all(
            torch.equal(runs[0][i][k], runs[1][i][k]) for i in (1, 2) for k in runs[0][1])
        print(f"[parallel] a data-parallel train step ({runs[1][3]}, UNet-XL B={B}; its forward "
              f"and backward, then its update, replayed from graphs with the all-reduce between "
              f"them) against the plain one replayed from its graph, {n_steps} steps: losses "
              f"{runs[1][0]} vs {runs[0][0]}, parameters and EMA bit for bit: {exact}; graphs "
              f"(captures, replays) {graph_counts[1]} vs {graph_counts[0]}; resblock launches "
              f"{step_counts} (expected {33 * n_steps} each); a replayed step (wall, synced) "
              f"{replay_ms[1]:.3f} ms vs {replay_ms[0]:.3f} ms [{card}]", flush=True)
        want_graphs = [[(1, n_steps - 2)], [(1, n_steps - 2)] * 2]
        if not exact or step_counts != [33 * n_steps] * 2 or graph_counts != want_graphs or \
                runs[1][3] != "BufferedTrainStep":
            raise SystemExit("the data-parallel train step differs from the plain one")
        out["train_step_bit_exact"] = exact
        out["train_step_replay_ms"] = {"dp": replay_ms[1], "plain": replay_ms[0]}
        del runs

        # the tensor-parallel forward on a 1x1 mesh
        mesh2 = make_mesh_2d(1, 1)
        text, obs, mask = keyframe_inputs(B, 4)
        x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=12)
        t = torch.arange(B, device=dev) * 97
        y = {"text_embed": text.to(dev)}
        kw = dict(obs_x0=obs.to(dev), obs_mask=mask.to(dev))
        mdm = build_mdm(dev, torch.float32)
        for label, net, args, kernel, per in (("UNet-XL", model, kw, "fused_conv_gn_mish", 33),
                                              ("MDM", mdm, {}, "fused_self_attention", 8)):
            tpm = tensor_parallel(net, mesh2)
            with torch.no_grad():
                reset_counts()
                got = tpm(x, t, y, **args)
                torch.cuda.synchronize()
                n = read_counts()[kernel]
                want = net(x, t, y, **args)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            print(f"[parallel] tensor-parallel {label} forward on a 1x1 mesh against the plain "
                  f"forward: max|diff| {err:.3e} (tol {TP_FORWARD_TOL:.0e} x (1+{scale:.3f})); "
                  f"{kernel} launches {n} (expected {per})", flush=True)
            if err > TP_FORWARD_TOL * (1 + scale) or n != per or not torch.isfinite(got).all():
                raise SystemExit(f"tensor-parallel {label} forward differs from the plain one")
            out[f"tp_{label}_forward_max_abs_err"] = err
            del tpm
        del model, mdm
    finally:
        dist.destroy_process_group()
    print(f"[parallel] one card shows world size 1 only: the collectives run (NCCL all-reduce "
          f"and all-gather of one rank) but split nothing [{card}]", flush=True)
    return out


# --------------------------------------------------------------------------- #
# phase 38's mock assets (also written by tests/test_torch_parity.py on the CPU)
# --------------------------------------------------------------------------- #
GLOVE_WORDS = ("sos", "eos", "unk", "a", "person", "walks")


def reference_unet_state_dict(params: dict) -> dict:
    """A Flax UNet tree ({"params": ...}, models/factory.py's layout) in the reference
    MDM_UNET .pt layout: the inverse of utils/checkpoint.convert_unet_state_dict,
    which reads it back."""
    p = params["params"]
    sd = {}

    def put(name, value):
        sd[name] = torch.from_numpy(np.ascontiguousarray(np.asarray(value, np.float32)))

    def dense(pre, d):
        put(f"{pre}.weight", np.asarray(d["kernel"]).T)
        put(f"{pre}.bias", d["bias"])

    def conv(pre, d):
        put(f"{pre}.weight", np.asarray(d["kernel"]).transpose(2, 1, 0))
        put(f"{pre}.bias", d["bias"])

    def norm(pre, d):
        put(f"{pre}.weight", d["scale"])
        put(f"{pre}.bias", d["bias"])

    def res_block(pre, d):
        dense(f"{pre}.time_mlp.1", d["time_mlp"])
        conv(f"{pre}.blocks.1.block.0", d["block2"]["conv"])
        norm(f"{pre}.blocks.1.block.2", d["block2"]["norm"])
        conv(f"{pre}.blocks.0.block1.0", d["block1"]["conv"])
        norm(f"{pre}.blocks.0.block1.2", d["block1"]["norm"])
        if "residual_conv" in d:
            conv(f"{pre}.residual_conv", d["residual_conv"])

    dense("embed_timestep.time_embed.0", p["embed_timestep"]["fc1"])
    dense("embed_timestep.time_embed.2", p["embed_timestep"]["fc2"])
    if "embed_text" in p:
        dense("embed_text", p["embed_text"])
    u = p["unet"]
    dense("unet.time_mlp.0", u["time_fc1"])
    dense("unet.time_mlp.2", u["time_fc2"])
    n_levels = sum(1 for k in u if k.startswith("down") and k.endswith("_res1"))
    for i in range(n_levels):
        res_block(f"unet.downs.{i}.0", u[f"down{i}_res1"])
        res_block(f"unet.downs.{i}.1", u[f"down{i}_res2"])
        if f"down{i}_downsample" in u:
            conv(f"unet.downs.{i}.3.conv", u[f"down{i}_downsample"])
    res_block("unet.mid_block1", u["mid_block1"])
    res_block("unet.mid_block2", u["mid_block2"])
    for i in range(n_levels - 1):
        res_block(f"unet.ups.{i}.0", u[f"up{i}_res1"])
        res_block(f"unet.ups.{i}.1", u[f"up{i}_res2"])
        if f"up{i}_upsample" in u:
            d = u[f"up{i}_upsample"]  # Flax ConvTranspose [k, in, out], flipped along k
            put(f"unet.ups.{i}.3.conv.weight", np.asarray(d["kernel"])[::-1].transpose(1, 2, 0))
            put(f"unet.ups.{i}.3.conv.bias", d["bias"])
    conv("unet.final_conv.0.block.0", u["final_block"]["conv"])
    norm("unet.final_conv.0.block.2", u["final_block"]["norm"])
    conv("unet.final_conv.1", u["final_conv"])
    return sd


def write_reference_checkpoint(path: Path, model, model_args: dict) -> Path:
    """The model's weights as a released-layout model####.pt ({"model", "model_avg"})
    with its args.json beside it."""
    from condmdi_tpu_torch.weights import to_flax_params

    sd = reference_unet_state_dict(to_flax_params(model.state_dict()))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": sd, "model_avg": sd}, path)
    (path.parent / "args.json").write_text(json.dumps(model_args))
    return path


def write_mock_evaluator_assets(root: Path, seed: int = 0) -> None:
    """GloVe files over a few words and a T2M evaluator finest.tar with the
    reference's state-dict layout at its real widths, random."""
    import pickle

    g = root / "glove"
    g.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    np.save(g / "our_vab_data.npy", rng.standard_normal((len(GLOVE_WORDS), 300)).astype(np.float32))
    with open(g / "our_vab_words.pkl", "wb") as fh:
        pickle.dump(list(GLOVE_WORDS), fh)
    with open(g / "our_vab_idx.pkl", "wb") as fh:
        pickle.dump({w: i for i, w in enumerate(GLOVE_WORDS)}, fh)

    gen = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    def bigru(inp, hid, out_in, out_hid, pos=None):
        sd = {"input_emb.weight": w(hid, inp), "input_emb.bias": w(hid),
              "gru.weight_ih_l0": w(3 * hid, hid), "gru.weight_hh_l0": w(3 * hid, hid),
              "gru.bias_ih_l0": w(3 * hid), "gru.bias_hh_l0": w(3 * hid),
              "gru.weight_ih_l0_reverse": w(3 * hid, hid),
              "gru.weight_hh_l0_reverse": w(3 * hid, hid),
              "gru.bias_ih_l0_reverse": w(3 * hid), "gru.bias_hh_l0_reverse": w(3 * hid),
              "hidden": w(2, 1, hid),
              "output_net.0.weight": w(out_hid, 2 * hid), "output_net.0.bias": w(out_hid),
              "output_net.1.weight": torch.ones(out_hid), "output_net.1.bias": w(out_hid),
              "output_net.3.weight": w(out_in, out_hid), "output_net.3.bias": w(out_in)}
        if pos is not None:
            sd["pos_emb.weight"], sd["pos_emb.bias"] = w(pos[1], pos[0]), w(pos[1])
        return sd

    t = root / "t2m" / "text_mot_match" / "model"
    t.mkdir(parents=True, exist_ok=True)
    torch.save({"movement_encoder": {"main.0.weight": w(512, 259, 4), "main.0.bias": w(512),
                                     "main.3.weight": w(512, 512, 4), "main.3.bias": w(512),
                                     "out_net.weight": w(512, 512), "out_net.bias": w(512)},
                "motion_encoder": bigru(512, 1024, 512, 1024),
                "text_encoder": bigru(300, 512, 512, 512, pos=(15, 300))},
               t / "finest.tar")


def write_mock_humanml(root: Path, n: int = 36, frames: int = 64, device="cpu") -> Path:
    """A HumanML3D tree of n clips (relative and abs-root features from the
    synthetic set's codec, one caption each), its test split and the stats files
    (the synthetic population's)."""
    from condmdi_tpu_torch.data import dataset as tds

    d = root / "dataset" / "HumanML3D"
    texts = d / "texts"
    texts.mkdir(parents=True, exist_ok=True)
    names = [f"{i:06d}" for i in range(n)]
    for abs_3d, sub in ((False, "new_joint_vecs"), (True, "new_joint_vecs_abs_3d")):
        feats, _ = tds.SyntheticMotionDataset._make_items(
            tds.DatasetConfig(abs_3d=abs_3d), 3, n, frames + 1, torch.device(device))
        (d / sub).mkdir(exist_ok=True)
        for name, f in zip(names, feats):
            np.save(d / sub / f"{name}.npy", f)
    for name in names:
        (texts / f"{name}.txt").write_text("a person walks#a/DET person/NOUN walks/VERB##\n")
    (d / "test.txt").write_text("\n".join(names) + "\n")
    stats = {k: np.load(ROOT / "condmdi_tpu_torch" / "data" / f"synthetic_stats_{k}.npz")
             for k in ("rel", "abs")}
    (root / "dataset" / "HumanML3D_abs").mkdir(exist_ok=True)
    np.save(d / "Mean.npy", stats["rel"]["mean"])
    np.save(d / "Std.npy", stats["rel"]["std"])
    np.save(root / "dataset" / "t2m_mean.npy", stats["rel"]["mean"])
    np.save(root / "dataset" / "t2m_std.npy", stats["rel"]["std"])
    np.save(root / "dataset" / "HumanML3D_abs" / "Mean_abs_3d.npy", stats["abs"]["mean"])
    np.save(root / "dataset" / "HumanML3D_abs" / "Std_abs_3d.npy", stats["abs"]["std"])
    return d


# --------------------------------------------------------------------------- #
# phase 40: wide and long resblock halves (the split route)
# --------------------------------------------------------------------------- #
# (B, T, Cin, Cout) on the split route: groups of 136 (no multiple of the 128-channel
# tile), 256 and 512 channels, then lengths past a cluster of 8 row tiles
SPLIT_CALLS = [
    (2, 224, 512, 8 * 136), (2, 25, 512, 8 * 136), (4, 224, 2048, 8 * 256),
    (4, 28, 4096, 8 * 256), (2, 56, 1024, 8 * 512),
    (2, 1025, 256, 1024), (2, 1280, 1024, 1024), (1, 2048, 128, 512), (1, 4096, 64, 256),
]
# the keyframe UNet-XL at --latent_dim 1024 (2,048 channels, groups of 256), built
# through create_model_and_diffusion as the conditional CLI builds it; DDIM-20
LATENT1024_ARGV = ["--arch", "unet", "--latent_dim", "1024", "--dim_mults", "2", "2", "2", "2",
                   "--unet_pad_to", "224", "--unet_zero", "false", "--keyframe_conditioned",
                   "true", "--use_ddim", "true", "--timestep_respacing", "ddim20"]
LATENT1024_CLI_B, LATENT1024_SERVED_B = 4, 8  # the CLI's 2 samples x CFG; 4 requests x CFG
PAD1280, PAD1280_B = 1280, 2  # UNet-XL at --unet_pad_to 1280


def split_calls(dev):
    """The split route per call against plain at every SPLIT_CALLS shape, in both
    types, with and without AdaGN and the residual; two launches on the same inputs
    bit for bit. Returns the largest error of each type."""
    from condmdi_tpu_torch.ops.resblock import fused_conv_gn_mish, resblock_plan

    gen = torch.Generator().manual_seed(40)
    errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for B, T, cin, cout in SPLIT_CALLS:
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            if resblock_plan(B, T, cin, cout, dtype).route != "split":
                raise SystemExit(f"B={B} T={T} Cout={cout}: not on the split route")
            for ada, res in ((True, True), (False, False)):
                errs[dtype] = max(errs[dtype], kernel_against_plain(
                    B, T, cin, cout, ada, res, cin, dtype, tol, gen, dev))
            args, kw = make_case(B, T, cin, cout, True, True, dtype, gen, dev)
            with torch.no_grad():
                same = torch.equal(fused_conv_gn_mish(*args, **kw), fused_conv_gn_mish(*args, **kw))
            if not same:
                raise SystemExit(f"split route B={B} T={T} Cout={cout} {dtype}: two launches "
                                 "on the same inputs differ")
    print(f"[split] {len(SPLIT_CALLS)} shapes x 2 types x 2 forms within tolerance, each shape "
          f"bit for bit twice; largest errors bf16 {errs[torch.bfloat16]:.3e}, f32 "
          f"{errs[torch.float32]:.3e}", flush=True)
    return {"bf16": errs[torch.bfloat16], "f32": errs[torch.float32]}


def latent1024_model(dev):
    """The latent-1024 UNet-XL and its GaussianDiffusion through
    create_model_and_diffusion; weights from a seed, then perturbed on the card."""
    from condmdi_tpu_torch.diffusion import GaussianDiffusion
    from condmdi_tpu_torch.models import create_model_and_diffusion
    from condmdi_tpu_torch.models.layers import init_params
    from condmdi_tpu_torch.utils.config import CondSyntArgs, parse_args

    model, sched, dcfg = create_model_and_diffusion(parse_args(CondSyntArgs, LATENT1024_ARGV),
                                                    device=dev)
    init_params(model, 0)
    gen = torch.Generator(dev).manual_seed(12)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device=dev))
    return model.requires_grad_(False).eval(), GaussianDiffusion(sched.to(dev), dcfg)


def split_launches() -> int:
    from condmdi_tpu_torch.ops.resblock import fused_conv_gn_mish

    return fused_conv_gn_mish.split_launches


def counted(call):
    """call()'s result, its resblock launches and, of those, the split route's: the
    counts set to 0 just before it and read just after."""
    from condmdi_tpu_torch.ops.resblock import fused_conv_gn_mish

    reset_counts()
    fused_conv_gn_mish.split_launches = 0
    with torch.no_grad():
        out = call()
    return out, read_counts()["fused_conv_gn_mish"], split_launches()


def wide_long_phase40(dev, card):
    """The latent-1024 UNet-XL (f32 forward at the CLI's B=4, bf16 at the served B=8,
    kernel against plain; a DDIM-20 run through GaussianDiffusion.p_mean_variance;
    recover_from_rot on the card on its motion against the CPU) and UNet-XL at
    --unet_pad_to 1280 (B=2, a forward in each type against plain); then the halves
    of each forward timed at the four points."""
    import copy

    from condmdi_tpu_torch.data.humanml_repr import recover_from_rot
    from condmdi_tpu_torch.diffusion.gaussian import predict_eps_from_xstart
    from condmdi_tpu_torch.geometry.skeleton import t2m_skeleton
    from condmdi_tpu_torch.models.unet import MDM_UNET, cast_weights

    out = {"split_calls": split_calls(dev)}
    model, diffusion = latent1024_model(dev)
    served = cast_weights(copy.deepcopy(model), torch.bfloat16).requires_grad_(False).eval()
    results = {}
    for label, net, B, dtype in (("latent-1024 f32", model, LATENT1024_CLI_B, torch.float32),
                                 ("latent-1024 bf16", served, LATENT1024_SERVED_B,
                                  torch.bfloat16)):
        text, obs, mask = keyframe_inputs(B, 40)
        x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=41).to(dtype)
        t = torch.full((B,), 600, device=dev)
        y, kw = {"text_embed": text.to(dev, dtype)}, dict(obs_x0=obs.to(dev, dtype),
                                                          obs_mask=mask.to(dev))

        def call(net=net, x=x, t=t, y=y, kw=kw):
            return net(x, t, y, **kw)

        _, launches, split = counted(call)
        if launches != 33 or not split:
            raise SystemExit(f"{label}: {launches} resblock launches a forward ({split} on the "
                             "split route), expected 33")
        if dtype == torch.float32:
            with torch.no_grad():
                err = kernel_vs_plain("latent1024", f"{label} forward B={B}", call,
                                      resblock_swapped_for_plain)
            results[label] = dict(launches=launches, split_launches=split, max_abs_err=err)
        else:
            err, rel = bf16_forward_kernel_vs_plain(f"{label} forward B={B}", call,
                                                    resblock_swapped_for_plain)
            results[label] = dict(launches=launches, split_launches=split, max_abs_err=err,
                                  rel_rms=rel)
        shapes = record_resblock_shapes(net, x, t, y, kw)
        results[label]["rows"] = resblock_rows("latent-1024 UNet-XL pad 224", shapes, B,
                                               dev, dtype)
    del served
    # DDIM-20 (eta 0) through GaussianDiffusion.p_mean_variance, f32, the CLI's B
    B = LATENT1024_CLI_B
    text, obs, mask = keyframe_inputs(B, 42)
    y, kw = {"text_embed": text.to(dev)}, dict(obs_x0=obs.to(dev), obs_mask=mask.to(dev))
    sched = diffusion.sched

    def ddim():
        x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=43)
        with torch.no_grad():
            for i in range(diffusion.num_timesteps - 1, -1, -1):
                t = torch.full((B,), i, device=dev, dtype=torch.long)
                pm = diffusion.p_mean_variance(lambda z, tm: model(z, tm, y, **kw), x, t)
                eps = predict_eps_from_xstart(sched, x, t, pm["pred_xstart"])
                abar_prev = sched.extract(sched.alphas_cumprod_prev, t, x.ndim)
                x = pm["pred_xstart"] * abar_prev.sqrt() + (1 - abar_prev).clamp(min=0).sqrt() * eps
        return x

    motion, ddim_launches, ddim_split = counted(ddim)
    if ddim_launches != 33 * diffusion.num_timesteps or not ddim_split:
        raise SystemExit(f"latent-1024 DDIM-20: {ddim_launches} resblock launches")
    results["ddim20"] = dict(launches=ddim_launches, split_launches=ddim_split,
                             max_abs_err=kernel_vs_plain(
        "latent1024", f"latent-1024 f32 DDIM-20 B={B} through GaussianDiffusion.p_mean_variance",
        ddim, resblock_swapped_for_plain))
    # recover_from_rot on the card on the sampled motion, against the same call on the CPU
    pose = np.random.default_rng(44).standard_normal((22, 3)).astype(np.float32)
    offsets = torch.from_numpy(t2m_skeleton.offsets_from_reference_pose(pose))
    joints = recover_from_rot(motion, 22, offsets.to(dev))
    want = recover_from_rot(motion.cpu(), 22, offsets)
    rot_err = (joints.cpu() - want).abs().max().item()
    ok = torch.isfinite(joints).all() and joints.shape == (B, T_FRAMES, 22, 3) and \
        bool(((joints.cpu() - want).abs() <= 1e-4 * (1 + want.abs())).all())
    print(f"[latent1024] recover_from_rot on the card against the CPU: {tuple(joints.shape)}, "
          f"max |card - cpu| = {rot_err:.3e} (tol 1e-4*(1+|cpu|))", flush=True)
    if not ok:
        raise SystemExit("recover_from_rot on the card disagrees with the CPU")
    results["recover_from_rot_max_abs_err"] = rot_err
    del model, diffusion
    torch.cuda.empty_cache()
    out["latent1024"] = results

    # UNet-XL at --unet_pad_to 1280, B=2: a forward in each type against plain
    pad = {}
    xl = perturbed(MDM_UNET(**dict(XL, pad_frames_to=PAD1280), device=dev, seed=0), dev,
                   torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        net = xl if dtype == torch.float32 else cast_weights(xl, torch.bfloat16)
        B = PAD1280_B
        rng = np.random.default_rng(45)
        x = torch.from_numpy(rng.standard_normal((B, PAD1280, FEATS)).astype(np.float32)).to(
            dev, dtype)
        obs = torch.from_numpy(0.1 * rng.standard_normal((B, PAD1280, FEATS)).astype(
            np.float32)).to(dev, dtype)
        mask = torch.zeros((B, PAD1280, FEATS), dtype=torch.bool, device=dev)
        mask[:, ::10] = True
        y = {"text_embed": torch.from_numpy(rng.standard_normal((B, 512)).astype(
            np.float32)).to(dev, dtype)}
        t = torch.full((B,), 300, device=dev)
        kw = dict(obs_x0=obs, obs_mask=mask)

        def call(net=net, x=x, t=t, y=y, kw=kw):
            return net(x, t, y, **kw)

        label = f"UNet-XL pad 1280 {'f32' if dtype == torch.float32 else 'bf16'}"
        _, launches, split = counted(call)
        if launches != 33 or not split:
            raise SystemExit(f"{label}: {launches} resblock launches a forward ({split} on the "
                             "split route), expected 33")
        if dtype == torch.float32:
            with torch.no_grad():
                row = dict(launches=launches, split_launches=split, max_abs_err=kernel_vs_plain(
                    "pad1280", f"{label} forward B={B}", call, resblock_swapped_for_plain))
        else:
            err, rel = bf16_forward_kernel_vs_plain(f"{label} forward B={B}", call,
                                                    resblock_swapped_for_plain)
            row = dict(launches=launches, split_launches=split, max_abs_err=err, rel_rms=rel)
        row["rows"] = resblock_rows("UNet-XL pad 1280", record_resblock_shapes(
            net, x, t, y, kw), B, dev, dtype)
        pad[label] = row
    del xl, net
    torch.cuda.empty_cache()
    out["pad1280"] = pad
    return out


def split_summary(phase40):
    """The four timed points of phase 40: every half of a forward summed, and the
    split route's halves alone."""
    points = {}
    for group in ("latent1024", "pad1280"):
        for label, res in phase40[group].items():
            if not isinstance(res, dict) or "rows" not in res:
                continue
            rows = res["rows"]["rows"]
            split = [r for r in rows if r["route"] == "split"]
            point = {k: res["rows"][k] for k in ("halves", "ms", "plain_ms", "library_ms",
                                                  "bound_ms", "host_ms_per_call")}
            point["split_halves"] = sum(r["per_forward"] for r in split)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                point[f"split_{k}"] = sum(r[k] * r["per_forward"] for r in split)
            points[f"{label}, B={rows[0]['B']}"] = point
    return points


# --------------------------------------------------------------------------- #
# phase 41: the float32 dense kernel (tf32x3) at MDM's encoder projections
# --------------------------------------------------------------------------- #
DENSE_ROWS = 64 * MDM_TOKENS  # evals.run_t2m's batch: 32 samples under CFG, T = 197
DENSE_SWEEP_ROWS = (64, 128, 197, 256, 394, 512, 788, 1024, 1952, 3152, 6304, DENSE_ROWS)
DENSE_CHECK_ROWS = (DENSE_ROWS, 32 * 61, 4 * MDM_TOKENS)  # and a2m's B=32 at T=61, edit's B=4
# The kernel's largest error against a float64 product, at most this many times
# cuBLAS's float32 product's (TF32 off) on the same operands; cuBLAS in TF32 fails it.
DENSE_ERR_RATIO = 4.0


def dense_bound_ms(M, K, N) -> tuple[float, str]:
    """Three TF32 products at 495 TFLOP/s, or x, the two planes, the bias and y once."""
    t_ops = 3 * 2.0 * M * K * N / PEAK_F32_FLOPS
    t_bytes = 4.0 * (M * K + 2 * N * K + N + M * N) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def dense_case(M, K, N, gen, dev):
    """x ~ N(0, 1) (a LayerNorm's output), W LeCun-normal, b ~ N(0, 0.02^2)."""
    from condmdi_tpu_torch.ops.dense import split_weight

    x = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((N, K), generator=gen, device=dev) * K ** -0.5
    b = torch.randn((N,), generator=gen, device=dev) * 0.02
    return x, w, split_weight(w), b


def dense_errors(x, w, planes, b):
    """Largest |y - x.W^T - b| (float64) of the kernel, the plain version, cuBLAS in
    float32 and cuBLAS in TF32; the kernel's output."""
    from condmdi_tpu_torch.ops.dense import _launch, tf32x3_linear

    want = torch.addmm(b.double(), x.double(), w.double().T)
    with torch.no_grad():
        got = _launch(x, planes, b)
        torch.cuda.synchronize()
        plain = tf32x3_linear(x, planes, b)
        f32 = F.linear(x, w, b)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = F.linear(x, w, b)
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = {k: (v.double() - want).abs().max().item()
            for k, v in (("kernel", got), ("plain", plain), ("cublas_f32", f32),
                         ("cublas_tf32", tf32))}
    errs["kernel_vs_plain"] = (got - plain).abs().max().item()
    return errs, got


def dense_rows(dev, seed=41):
    """The kernel per call at MDM's four projections at each of DENSE_CHECK_ROWS rows,
    with and without bias, against float64, its plain version and cuBLAS; then its
    time beside cuBLAS's float32 GEMM (library), the plain version and the bound at
    DENSE_ROWS, with the host enqueue."""
    from condmdi_tpu_torch.ops.dense import _launch, dense, tf32x3_linear

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for K, N in MDM_QDENSE:
        checked = []
        for M in DENSE_CHECK_ROWS:
            x, w, planes, b = dense_case(M, K, N, gen, dev)
            for bias in (b, None):
                before = dense.launches
                errs, got = dense_errors(x, w, planes, b if bias is not None else torch.zeros_like(b))
                if bias is None:  # the same product with no bias pointer at all
                    with torch.no_grad():
                        unbiased = _launch(x, planes, None)
                    if not torch.equal(unbiased, got):
                        raise SystemExit(f"dense {M}x{K}x{N}: null bias differs from zero bias")
                ok = (errs["kernel"] <= DENSE_ERR_RATIO * errs["cublas_f32"]
                      and errs["kernel_vs_plain"] <= DENSE_ERR_RATIO * errs["cublas_f32"]
                      and errs["cublas_tf32"] > DENSE_ERR_RATIO * errs["cublas_f32"]
                      and dense.launches - before == 1 + (bias is None))
                print(f"[dense] M={M} K={K} N={N} bias={bias is not None}: max |err| vs float64: "
                      f"kernel {errs['kernel']:.3e}, plain {errs['plain']:.3e}, cuBLAS f32 "
                      f"{errs['cublas_f32']:.3e}, cuBLAS TF32 {errs['cublas_tf32']:.3e}; kernel "
                      f"against plain {errs['kernel_vs_plain']:.3e} "
                      f"(kernel / f32 {errs['kernel'] / errs['cublas_f32']:.2f}, limit "
                      f"{DENSE_ERR_RATIO})", flush=True)
                if not ok or not torch.isfinite(got).all():
                    raise SystemExit(f"the dense kernel fails its check at {M}x{K}x{N}: {errs}")
                checked.append(errs)
        per_set = 4 * (DENSE_ROWS * K + 3 * N * K + DENSE_ROWS * N)
        sets = [dense_case(DENSE_ROWS, K, N, gen, dev) for _ in range(max(2, -(-64 * 2**20 // per_set)))]
        row = dict(M=DENSE_ROWS, K=K, N=N, max_abs_err=max(e["kernel"] for e in checked),
                   max_err_over_cublas_f32=max(e["kernel"] / e["cublas_f32"] for e in checked))
        with torch.no_grad():
            row["ms"], row["host_ms"] = timed_ms(lambda x, w, p, b: _launch(x, p, b), sets)
            row["plain_ms"], _ = timed_ms(lambda x, w, p, b: tf32x3_linear(x, p, b), sets)
            row["library_ms"], row["library_host_ms"] = timed_ms(
                lambda x, w, p, b: F.linear(x, w, b), sets)
        row["bound_ms"], row["bound_by"] = dense_bound_ms(DENSE_ROWS, K, N)
        row["tflops"] = 2.0 * DENSE_ROWS * K * N / row["ms"] / 1e9
        row["library_tflops"] = 2.0 * DENSE_ROWS * K * N / row["library_ms"] / 1e9
        print(f"[dense] times M={DENSE_ROWS} K={K} N={N}: kernel {row['ms']:.4f} ms "
              f"({row['tflops']:.1f} TFLOP/s of the layer's operations), library (cuBLAS f32) "
              f"{row['library_ms']:.4f} ms ({row['library_tflops']:.1f}), plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
              f"host enqueue: kernel wrapper {row['host_ms']:.4f} ms, F.linear "
              f"{row['library_host_ms']:.4f} ms", flush=True)
        rows.append(row)
        del sets
    return rows


def dense_sweep(dev, seed=43):
    """Kernel against cuBLAS's float32 GEMM at each of DENSE_SWEEP_ROWS rows and each
    projection: the fewest rows from which the kernel is the faster at all four."""
    from condmdi_tpu_torch.ops.dense import _launch

    gen = torch.Generator(device=dev).manual_seed(seed)
    sweep = []
    for M in DENSE_SWEEP_ROWS:
        point = {"M": M}
        for K, N in MDM_QDENSE:
            per_set = 4 * (M * K + 3 * N * K + M * N)
            sets = [dense_case(M, K, N, gen, dev) for _ in range(min(8, max(2, -(-64 * 2**20 // per_set))))]
            with torch.no_grad():
                kernel, _ = timed_ms(lambda x, w, p, b: _launch(x, p, b), sets)
                library, _ = timed_ms(lambda x, w, p, b: F.linear(x, w, b), sets)
            point[f"{K}x{N}"] = (kernel, library)
        sweep.append(point)
        print(f"[dense sweep] M={M}: kernel / cuBLAS f32 ms "
              + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in point.items() if k != "M"),
              flush=True)
    wins = [all(v[0] < v[1] for k, v in p.items() if k != "M") for p in sweep]
    first = next((p["M"] for i, p in enumerate(sweep) if all(wins[i:])), None)
    print(f"[dense sweep] the kernel is faster at all four projections from M = {first} on",
          flush=True)
    return {"points": sweep, "wins_from_rows": first}


def dense_mdm_forward(dev):
    """MDM forwards at B=64 (f32, then bf16) in no_grad: the launches and routes of
    each, the f32 forward against the same forward with every projection on
    cuBLAS, and both forwards' device times."""
    import condmdi_tpu_torch.models.mdm as mdm_mod
    from condmdi_tpu_torch.ops.dense import dense

    out = {}
    B = 64
    x = seeded_noise((B, T_FRAMES, FEATS), dev, seed=15)
    t = torch.full((B,), 500, device=dev)
    text, _, _ = keyframe_inputs(B, 8)
    y = {"text_embed": text.to(dev)}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_mdm(dev, dtype)
        xd = x.to(dtype)
        before, routes = dense.launches, dict(dense.routes)
        with torch.no_grad():
            got = model(xd, t, y).float()
        torch.cuda.synchronize()
        launches = dense.launches - before
        taken = {k: dense.routes[k] - routes[k] for k in routes}
        tag = "f32" if dtype == torch.float32 else "bf16"
        want_launches = 32 if dtype == torch.float32 else 0
        print(f"[dense] MDM {tag} forward at B={B}: {launches} dense launches, routes {taken}",
              flush=True)
        if launches != want_launches or not torch.isfinite(got).all():
            raise SystemExit(f"MDM {tag} forward: {launches} dense launches, want {want_launches}")
        row = {"launches": launches, "routes": taken}
        with torch.no_grad():
            row["ms"], row["host_ms"] = timed_ms(lambda: model(xd, t, y), [()], reps=3, iters=5)
        if dtype == torch.float32:
            route = mdm_mod.dense_route
            mdm_mod.dense_route = lambda *a: "cublas"
            try:
                with torch.no_grad():
                    want = model(xd, t, y).float()
                    row["cublas_ms"], _ = timed_ms(lambda: model(xd, t, y), [()], reps=3, iters=5)
            finally:
                mdm_mod.dense_route = route
            row["rel_rms_vs_cublas"] = ((got - want).pow(2).mean().sqrt()
                                        / want.pow(2).mean().sqrt()).item()
            print(f"[dense] MDM f32 forward at B={B}: {row['ms']:.3f} ms with the kernel, "
                  f"{row['cublas_ms']:.3f} ms on cuBLAS; rel rms between them "
                  f"{row['rel_rms_vs_cublas']:.2e}", flush=True)
            if not row["rel_rms_vs_cublas"] < 1e-5:
                raise SystemExit("MDM f32 forward: the kernel path is not float32's")
        out[tag] = row
    return out


def dense_phase41(dev, card):
    """Phase 41: the float32 dense kernel per call, its times, the route's row
    threshold from a sweep, and MDM forwards through it."""
    rows = dense_rows(dev)
    sweep = dense_sweep(dev)
    forward = dense_mdm_forward(dev)
    print(f"[dense] {card}", flush=True)
    return {"rows": rows, "sweep": sweep, "mdm_forward": forward}


def build_kernels() -> list[str]:
    """Build the four sources at once (one nvcc each) and print ptxas' register
    and spill lines and any note that it serialised wgmma."""
    from condmdi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    sources = ["resblock.cu", "attention.cu", "quant.cu", "dense.cu"]
    _build.build_all(sources)
    _build.load_resblock()
    _build.load_attention()
    _build.load_quant()
    _build.load_dense()
    print(f"[setup] kernels ready in {time.perf_counter() - t0:.2f} s (nvcc, in parallel: "
          + ", ".join(f"{s} {_build.build_seconds.get(s, 0.0):.2f} s" for s in sources) + ")",
          flush=True)
    for source in sources:
        seen, entry = set(), ""
        for line in _build.build_log.get(source, "").splitlines():
            # ptxas -v: registers and spills, one pair per instantiation (named by its
            # mangled entry), and once each any note that it serialised wgmma (C7510 to
            # C7518; C7519 only says where it put a warpgroup.arrive)
            note = line.split("in the function")[0].split("in function")[0].strip()
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "Used " in line or "spill" in line:
                print(f"[setup] ptxas {source}: {line.strip()} [{entry[-60:]}]", flush=True)
            elif "(C75" in line and "(C7519)" not in line and note not in seen:
                seen.add(note)
                print(f"[setup] ptxas {source}: {note}", flush=True)
    return sources


def main_path_shapes(dev):
    """The main path's resblock shapes, from one bf16 UNet-XL forward at B=8."""
    model = build_xl(dev, torch.bfloat16)
    text, obs, mask = keyframe_inputs(8, 2)
    shapes = record_resblock_shapes(
        model, torch.randn(8, T_FRAMES, FEATS, device=dev, dtype=torch.bfloat16),
        torch.full((8,), 500, device=dev), {"text_embed": text.to(dev)},
        dict(obs_x0=obs.to(dev), obs_mask=mask.to(dev)))
    if sum(shapes.values()) != 33:
        raise SystemExit(f"expected 33 resblock halves per forward, found {shapes}")
    return shapes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    dev = torch.device("cuda")
    card = card_line()
    print(f"[setup] {card}; python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_kernels()
    if sys.argv[1:] == ["dense"]:  # phase 41 alone
        dense41 = dense_phase41(dev, card)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_dense.json").write_text(
            json.dumps({"card": card, "dense": dense41}, indent=1))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0)}}))
        return 0
    shapes = main_path_shapes(dev)
    text, obs, mask = keyframe_inputs(8, 2)
    phase_seconds = {"1 setup": time.perf_counter() - t0}

    def phase(name, fn, *args):
        """Run one phase and keep its host seconds (the whole script has a time limit)."""
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        phase_seconds[name] = time.perf_counter() - start
        return out

    rows, big_rows = phase("2 resblock kernel", check_kernel, shapes, dev)
    f32_b8 = phase("2 resblock kernel f32 times", f32_resblock_rows, "UNet-XL pad 200", shapes, 8,
                   dev)
    ddim_err = phase("3 UNet-XL DDIM", ddim_kernel_vs_plain, dev)
    served = phase("4 UNet-XL serving", serve, dev, card)
    attn_rows = phase("5 attention kernels", check_attention, dev)
    attn_f32 = phase("5 attention kernels f32 times", f32_attention_rows, dev, ATTN_SHAPES)
    phase("5 attention CUDA graph", attention_graph_replay, dev)
    stream = phase("5 attention stream route", stream_rows, dev)
    mdm225 = phase("5 MDM forward at T = 225", mdm_225_forward, dev)
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
    unet_recg_err = phase("13 UNet-XL guidance", unet_recguidance_kernel_vs_plain, dev, "float")
    int8_recg_err = phase("14 UNet-XL int8_static guidance", unet_recguidance_kernel_vs_plain,
                          dev, "int8_static")
    cli15 = phase("15 CLI conditional", cli_phase15, card)
    cli16 = phase("16 CLI edit and synthesize", cli_phase16, card)
    cli17 = phase("17 CLI kernel against plain", cli_phase17, dev, card, cli15)
    eval18 = phase("18 evals.run on the gate checkpoint", eval_phase18, dev, card)
    eval19 = phase("19 evals.run_t2m on MDM", eval_phase19, dev, card)
    eval20 = phase("20 evaluation kernel against plain", eval_phase20, dev, card)
    train21 = phase("21 UNet-XL training", train_phase21, dev, card)
    train22 = phase("22 MDM training", train_phase22, dev, card)
    train23 = phase("23 training step kernel against plain", train_phase23,
                    train21.pop("loop"), train22.pop("loop"))
    graphs24 = phase("24 CUDA graphs against eager", graphs_phase24, dev, card, int8_model)
    del int8_model
    gmd25 = phase("25 trajectory model kernel", gmd_phase25, dev, card)
    gmd26 = phase("26 generate_gmd", gmd_phase26, dev, card)
    cond27 = phase("27 evals.run_condition", gmd_phase27, dev, card)
    plms28 = phase("28 PLMS and DDIM reverse", plms_phase28, dev, card)
    a2m29 = phase("29 evals.run_a2m humanact12", a2m_phase29, dev, card)
    a2m30 = phase("30 evals.run_a2m uestc and default widths", a2m_phase30, dev, card)
    unc31 = phase("31 evals.run_unconstrained", unconstrained_phase31, dev, card)
    var32 = phase("32 model variants", variants_phase32, dev, card)
    unc33 = phase("33 UNet-XL unconstrained training", unconstrained_phase33, dev, card)
    smpl34 = phase("34 SMPL losses in training", smpl_phase34, dev, card)
    fit35 = phase("35 joints2smpl", joints2smpl_phase35, dev, card)
    amass36 = phase("36 AMASS", amass_phase36, dev, card)
    data37 = phase("37 file-backed datasets", datasets_phase37, dev, card)
    parity38 = phase("38 evals.parity on mock assets", parity_phase38, dev, card)
    par39 = phase("39 parallel/ at world size 1", parallel_phase39, dev, card)
    wide40 = phase("40 wide and long resblock halves", wide_long_phase40, dev, card)
    dense41 = phase("41 float32 dense kernel", dense_phase41, dev, card)
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
    a2m_stream = next(r for r in stream if r["shape"] == "a2m_cli_default")
    kernels = [{
        "name": "fused_conv_gn_mish",
        "route": "cuda",
        "source": "condmdi_tpu_torch/csrc/resblock.cu",
        "replaces": "condmdi_tpu/ops/resblock.py:53",
        "launches": served["launches"]["fused_conv_gn_mish"],
        "max_abs_err": max(r["max_abs_err_bf16"] for r in rows),
        "max_abs_err_f32": max(r["max_abs_err_f32"] for r in rows),
        "ddim_max_abs_err_f32": ddim_err,
        "recguidance_max_abs_err_f32": unet_recg_err,
        # times: the 33 resblock halves of one UNet-XL forward at B=8, bf16
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": bound_by(rows),
        "library_ms": per_forward("library_ms"),
        "host_ms_per_call": per_forward("host_ms") / 33,
        "bf16_forward_max_abs_err": served["bf16_forward_max_abs_err"],
        "bf16_forward_rel_rms": served["bf16_forward_rel_rms"],
        # the conditional CLI (phases 15, 17): f32, launches per run, per-call errors at
        # its shapes, and the halves of one forward at its batch, kernel against the others
        "cli_launches": {k: v["launches"]["fused_conv_gn_mish"] for k, v in cli15.items()},
        "cli_max_abs_err_f32": max(r["max_abs_err_f32"]
                                   for m in ("gate", "xl") for r in cli17[m]["rows"]),
        "cli_ddim_max_abs_err_f32": cli17["xl_ddim_err"],
        # the float32 route (redesigned on wgmma): the halves of one forward summed, at
        # phase 2's B=8 pad 200 and at the CLIs' shapes
        "f32_ms": {name: {k: f32[k] for k in ("halves", "ms", "plain_ms", "library_ms",
                                              "bound_ms", "host_ms_per_call")}
                   for name, f32 in (("UNet-XL pad 200, B=8", f32_b8),
                                     ("gate UNet pad 224, B=8", cli17["gate"]),
                                     ("UNet-XL pad 224, B=4", cli17["xl"]),
                                     ("gate UNet pad 224, B=32 (evals.run)",
                                      eval20["resblock_rows"]))},
        # the evaluation protocol (phases 18, 20): f32, the gate UNet at B=32
        "eval_launches": {"gate_float": eval18["float"]["launches"]["fused_conv_gn_mish"],
                          "gate_int8_f250": eval18["int8"]["launches"]["fused_conv_gn_mish"]},
        "eval_max_abs_err_f32": max(r["max_abs_err_f32"] for r in eval20["resblock_rows"]["rows"]),
        "eval_ddim_max_abs_err_f32": eval20["float"]["max_abs_err"],
        "eval_ddim_motions_rel_mean_rel": eval20["float"]["motions_rel_mean_rel"],
        # training (phases 21, 23): UNet-XL through main at B=64, pad 224
        "train_launches": {"xl_30_steps": train21["launches"],
                           "xl_resumed_10_steps": train21["resume_launches"],
                           "xl_timed_30_steps": train21["timed_launches"],
                           "xl_ema_ddim20_sample": train21["sample_launches"]},
        "train_ms": {k: train21["resblock_rows"][k]
                     for k in ("halves", "ms", "plain_ms", "library_ms", "bound_ms",
                               "host_ms_per_call")},
        "train_step_loss_abs_err": train23["xl"]["loss_abs_err"],
        "train_after_step_max_rel_err": train23["xl"]["after_step"]["max_rel_err"],
        # GMD (phases 25-28): the trajectory model's halves (f32, pad 224) summed at B=2
        # (generate_gmd) and B=32 (run_condition), launches per run, kernel against plain
        "traj_f32_ms": {k: {kk: v[kk] for kk in ("halves", "ms", "plain_ms", "library_ms",
                                                 "bound_ms", "host_ms_per_call")}
                        for k, v in gmd25.items() if k.startswith("B=")},
        "traj_max_abs_err_f32": max(r["max_abs_err_f32"] for k, v in gmd25.items()
                                    if k.startswith("B=") for r in v["rows"]),
        "traj_xz_only_max_abs_err_f32": max(r["max_abs_err_f32"]
                                            for r in gmd25["xz_only_first_half"]),
        "gmd_guided_gradient_max_abs_err_f32": gmd25["guided_gradient"]["max_abs_err"],
        "gmd_launches": dict({m: r["launches"]["fused_conv_gn_mish"] for m, r in gmd26.items()},
                             run_condition=cond27["launches"]["fused_conv_gn_mish"]),
        "gmd_ddpm20_max_abs_err_f32": {m: r["ddpm20_max_abs_err"] for m, r in gmd26.items()},
        "plms_launches": {k: v["graphs"]["launches"]["fused_conv_gn_mish"]
                          for k, v in plms28.items() if k.startswith("order")},
        "plms_max_abs_err_f32": {k: v["max_abs_err"] for k, v in plms28.items()},
        # the model variants and unconstrained training (phases 32-33): a UNet-XL action
        # forward (pad 64), the unconstrained LinearAttention UNet-XL trained at B=64 and
        # sampled by conditional from its EMA; its halves at B=64 summed
        "xl_action_forward_max_abs_err_f32": var32["xl_action_forward_max_abs_err"],
        "unconstrained_train_launches": {"xl_10_steps": unc33["launches"],
                                         "xl_ema10_conditional":
                                             unc33["conditional"]["launches"]["fused_conv_gn_mish"]},
        "unconstrained_train_ms": {k: unc33["resblock_rows"][k]
                                   for k in ("halves", "ms", "plain_ms", "library_ms", "bound_ms",
                                             "host_ms_per_call")},
        "unconstrained_train_step_loss_abs_err": unc33["step_pair"]["loss_abs_err"],
        "unconstrained_train_after_step_max_rel_err":
            unc33["step_pair"]["after_step"]["max_rel_err"],
        # AMASS (phase 36): UNet-XL with 764 features, keyframes (first half Cin 1528), pad
        # 128, B=8: launches of the 1000-step DDPM, kernel against plain at DDIM-20, the
        # first half per call (f32 timed, bf16 checked) and all 33 halves summed
        "amass_launches": amass36["launches"],
        "amass_ddim20_max_abs_err_f32": amass36["ddim20_max_abs_err"],
        "amass_first_half_max_abs_err_bf16": amass36["first_half_bf16_max_abs_err"],
        "amass_first_half_f32": {k: amass36["first_half"][k]
                                 for k in ("cin", "cout", "T", "B", "max_abs_err_f32", "ms",
                                           "plain_ms", "library_ms", "bound_ms", "bound_by",
                                           "host_ms")},
        "amass_f32_ms": {k: amass36["resblock_rows"][k]
                         for k in ("halves", "ms", "plain_ms", "library_ms", "bound_ms",
                                   "host_ms_per_call")},
        # the file-backed HumanML3D training (phase 37), evals.parity on mocks (phase 38)
        "file_dataset_train_launches": data37["launches"],
        "parity_launches": parity38["launches"],
        # parallel/ at world size 1 on NCCL (phase 39)
        "dp_generate_eval_batch_bit_exact": par39["generate_eval_batch_bit_exact"],
        "dp_train_step_bit_exact": par39["train_step_bit_exact"],
        "tp_1x1_forward_max_abs_err_f32": par39["tp_UNet-XL_forward_max_abs_err"],
        # the split route (phase 40: groups wider than 128 channels, lengths past a cluster
        # of 8 tiles): its launches on the latent-1024 UNet-XL's forwards and DDIM-20 and
        # UNet-XL pad 1280's forwards, its largest per-call errors, those runs against
        # plain, and the halves of each forward summed at the four timed points
        "split_launches": sum(r["split_launches"] for r in
                              list(wide40["latent1024"].values()) + list(wide40["pad1280"].values())
                              if isinstance(r, dict)),
        "split_max_abs_err": wide40["split_calls"]["bf16"],
        "split_max_abs_err_f32": wide40["split_calls"]["f32"],
        "latent1024_forward_max_abs_err_f32": wide40["latent1024"]["latent-1024 f32"]["max_abs_err"],
        "latent1024_bf16_forward_rel_rms": wide40["latent1024"]["latent-1024 bf16"]["rel_rms"],
        "latent1024_ddim20_max_abs_err_f32": wide40["latent1024"]["ddim20"]["max_abs_err"],
        "pad1280_forward_max_abs_err_f32": wide40["pad1280"]["UNet-XL pad 1280 f32"]["max_abs_err"],
        "pad1280_bf16_forward_rel_rms": wide40["pad1280"]["UNet-XL pad 1280 bf16"]["rel_rms"],
        "recover_from_rot_card_vs_cpu_max_abs_err":
            wide40["latent1024"]["recover_from_rot_max_abs_err"],
        "split_ms": split_summary(wide40),
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
        # the edit and synthesize CLIs (phases 16, 17): f32 per launch at their shapes
        "cli_launches": {k: v["launches"]["fused_self_attention"] for k, v in cli16.items()},
        "cli_ddim_max_abs_err_f32": cli17["edit_ddim_err"],
        # the float32 route (route 2) per launch at phase 5's and the CLIs' shapes
        "f32_ms": [{k: r[k] for k in ("shape", "B", "T", "route", "max_abs_err_f32", "ms",
                                      "plain_ms", "library_ms", "bound_ms", "host_ms")}
                   for r in attn_f32 + cli17["attention"] + eval20["attention_rows"]],
        # evals.run_t2m (phase 19): MDM f32 at B=64 under CFG
        "eval_launches": {"t2m": eval19["launches"]["fused_self_attention"]},
        # training (phases 22, 23): MDM through main at B=64
        "train_launches": {"mdm_20_steps": train22["launches"]},
        "train_step_loss_abs_err": train23["mdm"]["loss_abs_err"],
        "train_after_step_max_rel_err": train23["mdm"]["after_step"]["max_rel_err"],
        # action-to-motion and unconstrained generation (phases 29-32): MDM f32 at B=32,
        # T=61; launches per run; kernel against plain at DDPM-20; per call at both widths
        "a2m_launches": {"run_a2m_humanact12": a2m29["main"]["launches"]["fused_self_attention"],
                         "run_a2m_uestc": a2m30["uestc"]["launches"]["fused_self_attention"],
                         "run_a2m_cli_default_widths":
                             a2m30["default"]["launches"]["fused_self_attention"],
                         "run_unconstrained": unc31["launches"]["fused_self_attention"]},
        "a2m_ddpm20_max_abs_err_f32": {"paper_width": a2m29["ddpm20_max_abs_err"],
                                       "cli_default_widths": a2m30["default_ddpm20_max_abs_err"]},
        "a2m_f32_ms": [{k: r[k] for k in ("shape", "B", "T", "D", "H", "route", "max_abs_err_f32",
                                          "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                          "host_ms")}
                       for r in a2m30["attention_rows"]],
        "large_forward_max_abs_err_f32": var32["large_forward_max_abs_err"],
        "large_ddim20_max_abs_err_f32": var32["large_ddim20_max_abs_err"],
        # training with the SMPL losses (phase 34): the a2m MDM at B=32, T=60 under autograd
        "smpl_train_launches": smpl34["launches"],
        "smpl_train_step_loss_abs_err": smpl34["loss_abs_err"],
        "smpl_train_step_grad_max_rel_err": smpl34["grad_max_rel_err"],
        "tp_1x1_forward_max_abs_err_f32": par39["tp_MDM_forward_max_abs_err"],
    }, {
        # the attention's streaming route (route 0 of the same wrapper): launches on
        # evals.run_a2m at the JAX CLIs' width through main (phase 30) and on the MDM
        # forward at T = 225 (phase 5); times per launch at the a2m shape, f32
        "name": "fused_self_attention_stream",
        "route": "cuda",
        "source": "condmdi_tpu_torch/csrc/attention.cu",
        "replaces": "condmdi_tpu/ops/attention.py:34",
        "launches": a2m30["default"]["launches"]["fused_self_attention"] + mdm225["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in stream if r["dtype"] == "bf16"),
        "max_abs_err_f32": max(r["max_abs_err"] for r in stream if r["dtype"] == "f32"),
        "mdm_225_forward_max_abs_err_f32": mdm225["max_abs_err"],
        "a2m_ddpm20_max_abs_err_f32": a2m30["default_ddpm20_max_abs_err"],
        **{k: a2m_stream[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "host_ms_per_call": a2m_stream["host_ms"],
        "shapes": [{k: r[k] for k in ("shape", "B", "T", "D", "H", "dtype", "in_place", "plan",
                                      "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "host_ms")} for r in stream],
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
        "recguidance_max_abs_err_f32": int8_recg_err,
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
        # the conditional CLI with --precision_mode int8 (phases 15, 17): f32 activations,
        # dynamic scale, B=4, pad 224
        "cli_launches": {"xl_int8": cli15["xl_int8"]["launches"]["int8_conv1d"]},
        "cli_max_abs_err_f32": max(r["max_abs_err_f32"] for r in cli17["int8"]["rows"]),
        "cli_bit_exact_at_every_conv_shape": all(r["bit_exact"] for r in cli17["int8"]["rows"]),
        "cli_ddim_max_abs_err_f32": cli17["xl_int8_ddim_err"],
        # its 41 convs at the XL int8 CLI's shapes (f32, dynamic scale, B=4, pad 224), summed
        "cli_ms": {k: cli17["int8"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        # evals.run --precision_mode int8_static (phases 18, 20): the gate UNet, f32
        # activations, static scale, B=32; its convs summed
        "eval_launches": {"gate_int8_f250": eval18["int8"]["launches"]["int8_conv1d"],
                          "gate_int8_f250_calibration":
                              eval18["int8"]["calibration"]["launches"]["int8_conv1d"]},
        "eval_max_abs_err_f32": max(r["max_abs_err_f32"] for r in eval20["int8_rows"]["rows"]),
        "eval_bit_exact_at_every_conv_shape": all(r["bit_exact"]
                                                  for r in eval20["int8_rows"]["rows"]),
        "eval_ddim_max_abs_err_f32": eval20["int8"]["max_abs_err"],
        "eval_ms": {k: eval20["int8_rows"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
    }, {
        # the float32 dense kernel (phase 41; replaces no TPU kernel: the JAX package leaves
        # MDM's projections to XLA): the 32 projections of one MDM f32 forward at B=64 under
        # CFG (evals.run_t2m's batch), summed from the four shapes' per-call times
        "name": "dense_tf32x3",
        "route": "cuda",
        "source": "condmdi_tpu_torch/csrc/dense.cu",
        "replaces": None,
        "launches": dense41["mdm_forward"]["f32"]["launches"],
        "max_abs_err_f32": max(r["max_abs_err"] for r in dense41["rows"]),
        "max_err_over_cublas_f32": max(r["max_err_over_cublas_f32"] for r in dense41["rows"]),
        **{k: 8 * sum(r[k] for r in dense41["rows"])
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "operations",
        "host_ms_per_call": statistics.mean(r["host_ms"] for r in dense41["rows"]),
        "wins_from_rows": dense41["sweep"]["wins_from_rows"],
        "mdm_f32_forward_rel_rms_vs_cublas": dense41["mdm_forward"]["f32"]["rel_rms_vs_cublas"],
    }]
    previous = {"fused_conv_gn_mish": PREV_RESBLOCK_MS, "fused_self_attention": PREV_ATTENTION_MS,
                "fused_self_attention_stream": PREV_STREAM_MS[("a2m_cli_default", "f32")],
                "int8_conv1d": PREV_INT8_MS}
    for kern in (k for k in kernels if k["name"] in previous):
        print(f"[kernel] before: {kern['name']} took {previous[kern['name']]} ms in its first "
              f"version (PERF.md section 6, an earlier run on an NVIDIA H100 80GB HBM3 at 700 W); "
              f"this run {kern['ms']:.4f} ms", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "shapes": rows, "shapes_b64": big_rows, "shapes_f32_b8": f32_b8, "serve": served,
         "attention_shapes": attn_rows, "attention_shapes_f32": attn_f32,
         "attention_stream": stream, "mdm_225_forward": mdm225,
         "serve_mdm": served_mdm, "mdm_forward_b128": bench_forward,
         "int8_shapes": int8_rows, "int8_qdense": dense_rows, "int8_paths": int8_out,
         "serve_mixed": mixed, "kernels": kernels,
         "cli": {"conditional": cli15, "mdm": cli16, "kernel_vs_plain": cli17},
         "eval": {"gate": eval18, "t2m": eval19, "kernel_vs_plain": eval20},
         "train": {"xl": train21, "mdm": train22, "step_pairs": train23},
         "graphs": graphs24,
         "gmd": {"trajectory_model": gmd25, "generate_gmd": gmd26, "run_condition": cond27,
                 "plms": plms28},
         "a2m": {"humanact12": a2m29, "uestc_and_default": a2m30, "unconstrained": unc31,
                 "variants": var32, "unconstrained_training": unc33},
         "rest": {"smpl_losses": smpl34, "joints2smpl": fit35, "amass": amass36,
                  "file_datasets": data37, "parity": parity38, "parallel": par39},
         "wide_long": wide40, "dense": dense41,
         "phase_seconds": phase_seconds,
         "previous_ms_from_perf_md": dict(previous, f32_resblock=PREV_F32_RESBLOCK_MS,
                                          f32_attention=PREV_F32_ATTENTION_MS)}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
