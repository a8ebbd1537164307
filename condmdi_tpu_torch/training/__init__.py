from condmdi_tpu_torch.training.keyframes import get_keyframes_mask, joint_to_full_mask
from condmdi_tpu_torch.training.loop import (
    TrainConfig,
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
)
