from condmdi_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    betas_for_alpha_bar,
    get_named_beta_schedule,
    space_timesteps,
)
from condmdi_tpu_torch.diffusion.gaussian import (
    GaussianDiffusion,
    DiffusionConfig,
    InpaintingState,
    LossType,
    ModelMeanType,
    ModelVarType,
    training_losses,
)
from condmdi_tpu_torch.diffusion.sampling import (
    SamplerConfig,
    GuidanceParams,
    ddim_sample_loop,
    ddpm_sample_loop,
    plms_sample_loop,
)
