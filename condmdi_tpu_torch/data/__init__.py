from condmdi_tpu_torch.data.layout import (
    HML_JOINT_NAMES,
    NUM_HML_JOINTS,
    HML_FEATURE_DIM,
    HML_ROOT_MASK,
    HML_LOWER_BODY_MASK,
    HML_UPPER_BODY_MASK,
    MAT_POS,
    MAT_ROT,
    MAT_VEL,
    MAT_CNT,
)
from condmdi_tpu_torch.data.humanml_repr import (
    recover_root_rot_pos,
    recover_from_ric,
    recover_from_rot,
    extract_features,
)
from condmdi_tpu_torch.data.dataset import (
    DatasetConfig,
    DataLoader,
    Text2MotionDataset,
    TextOnlyDataset,
    SyntheticMotionDataset,
    collate,
    get_dataset_loader,
)
