"""condmdi_tpu_torch — the PyTorch/CUDA port of condmdi_tpu for NVIDIA Hopper.

Serves keyframe-conditioned motion in-betweening with the temporal UNet
denoiser, and text-to-motion with the MDM transformer and DiT denoisers. Two
hand-written CUDA kernels for sm_90a carry them: every resblock half of the
UNet runs through csrc/resblock.cu (conv1d → GroupNorm → AdaGN → Mish →
+residual), every MDM/DiT self-attention through csrc/attention.cu. Each
kernel's plain PyTorch version serves CPU tensors only.

Module names mirror the JAX package so each counterpart is easy to find:
  diffusion/  schedules + respacing, Gaussian diffusion math, DDPM/DDIM loops
  models/     embeddings, temporal UNet (MDM_UNET), MDM transformer, DiT,
              text encoders, CFG wrapper
  ops/        the kernels' wrappers, their plain versions, their build
  csrc/       CUDA sources, compiled with nvcc at first use
  sampling/   SamplePipeline (model + schedule + guidance → motions)
  weights.py  Flax parameter tree → this package's state_dict
  serving.py  micro-batching MotionServer

Importing the package builds nothing and touches no device. The entry points
that run a model (the denoisers, `SamplePipeline`, `MotionServer`) run on CUDA
unless the caller passes `device="cpu"`. `DiffusionSchedule.create` only builds
constant tables: it makes them on the host by default and the pipeline moves
them to its own device.
"""

__version__ = "0.1.0"

__all__ = [
    "device",
    "diffusion",
    "models",
    "ops",
    "sampling",
    "serving",
    "weights",
]
