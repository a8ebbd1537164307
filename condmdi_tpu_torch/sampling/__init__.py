from condmdi_tpu_torch.sampling.pipeline import SamplePipeline, build_inpainting_state
from condmdi_tpu_torch.sampling.gmd import (
    CondKeyLocations,
    CondKeyLocationsWithSdf,
    get_kframes,
    kframes_to_target,
    two_stage_generate,
)
