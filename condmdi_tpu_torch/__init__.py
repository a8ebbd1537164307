"""condmdi_tpu_torch — the PyTorch/CUDA port of condmdi_tpu for NVIDIA Hopper.

Serves keyframe-conditioned motion in-betweening with the temporal UNet
denoiser (float, or the int8 serving variant with its float-tail mixed
step), and text-to-motion with the MDM transformer and DiT denoisers. Three
hand-written CUDA kernels for sm_90a carry them: every float resblock half of
the UNet runs through csrc/resblock.cu (conv1d → GroupNorm → AdaGN → Mish →
+residual), every MDM/DiT self-attention through csrc/attention.cu, every
int8 conv and dense through csrc/quant.cu. Each kernel's plain PyTorch
version serves CPU tensors only.

Module names mirror the JAX package so each counterpart is easy to find:
  diffusion/  schedules + respacing, Gaussian diffusion math, DDPM/DDIM loops
  models/     embeddings, temporal UNet (MDM_UNET), MDM transformer, DiT,
              text encoders, CFG wrapper, the factory from args, Flax's
              initialisation replayed in torch
  ops/        the kernels' wrappers, their plain versions, their build
  csrc/       CUDA sources, compiled with nvcc at first use
  sampling/   SamplePipeline (model + schedule + guidance → motions) and the
              CLIs: conditional (keyframe in-betweening), edit, synthesize
              (text to motion), templates (GMD presets)
  data/       the HumanML3D layout and feature codec, the synthetic dataset,
              collation, fixed-dataset fixtures
  geometry/   quaternions, skeleton FK/IK
  training/   keyframe observation masks for the 12 edit modes
  utils/      option dataclasses, argv parsing and args.json; checkpoint
              converters
  weights.py  Flax parameter tree → this package's state_dict
  serving.py  micro-batching MotionServer
  bench.py    the JAX bench's models without JAX, checked against its goldens

Importing the package builds nothing and touches no device. The entry points
that run a model (the denoisers, `SamplePipeline`, `MotionServer`, the CLIs'
`main`, the synthetic dataset's codec) run on CUDA unless the caller passes
`device="cpu"`. `DiffusionSchedule.create` only builds
constant tables: it makes them on the host by default and the pipeline moves
them to its own device.
"""

__version__ = "0.1.0"

__all__ = [
    "data",
    "device",
    "diffusion",
    "geometry",
    "models",
    "ops",
    "sampling",
    "serving",
    "training",
    "utils",
    "weights",
]
