from condmdi_tpu_torch.utils.layout import to_reference_layout, from_reference_layout
from condmdi_tpu_torch.utils.assets import find_assets_dir, load_norm_stats, NormStats
from condmdi_tpu_torch.utils import checkpoint, config, logger, tracing
