"""condmdi_tpu_torch — the PyTorch/CUDA port of condmdi_tpu for NVIDIA Hopper.

Serves keyframe-conditioned motion in-betweening with the temporal UNet
denoiser. Every resblock half of the UNet runs through one hand-written
CUDA kernel for sm_90a (csrc/resblock.cu: conv1d → GroupNorm → AdaGN → Mish
→ +residual); its plain PyTorch version serves CPU tensors only.

Module names mirror the JAX package so each counterpart is easy to find:
  diffusion/  schedules + respacing, Gaussian diffusion math, DDPM/DDIM loops
  models/     timestep embedding, temporal UNet (MDM_UNET), CFG wrapper
  ops/        the fused resblock kernel's wrapper, its plain version, its build
  csrc/       CUDA sources, compiled with nvcc at first use
  sampling/   SamplePipeline (model + schedule + guidance → motions)
  weights.py  Flax parameter tree → this package's state_dict
  serving.py  micro-batching MotionServer

Importing the package builds nothing and touches no device. Entry points
run on CUDA unless the caller passes `device="cpu"`.
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
