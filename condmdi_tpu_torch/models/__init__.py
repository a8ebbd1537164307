from condmdi_tpu_torch.models.unet import MDM_UNET, TemporalUnet
from condmdi_tpu_torch.models.mdm import MDM
from condmdi_tpu_torch.models.dit import MDM_DiT
from condmdi_tpu_torch.models.cfg import make_cfg_denoiser, make_plain_denoiser
from condmdi_tpu_torch.models.text import HashTextEncoder, CachedTextEncoder
from condmdi_tpu_torch.models.factory import (
    create_model,
    create_gaussian_diffusion,
    create_model_and_diffusion,
    get_model_dims,
)
