from condmdi_tpu_torch.models.unet import MDM_UNET, TemporalUnet
from condmdi_tpu_torch.models.cfg import make_cfg_denoiser, make_plain_denoiser
