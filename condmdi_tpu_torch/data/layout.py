"""HumanML3D 263-dim feature layout: static masks and joint↔feature matrices.

Feature vector layout (reference data_loaders/humanml_utils.py:38-92):
  [0]        root rotation (velocity, or absolute angle in abs_3d data)
  [1:3]      root linear velocity on xz (or absolute xz in abs_3d data)
  [3]        root height y
  [4:67]     ric: 21 non-root joints × 3 local positions
  [67:193]   rot: 21 non-root joints × 6 cont6d rotations
  [193:259]  vel: 22 joints × 3 local velocities
  [259:263]  foot contacts (L-ankle, L-foot, R-ankle, R-foot order: 7,10,8,11)

Counterpart of condmdi_tpu/data/layout.py (plain numpy, copied here so that
the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

HML_JOINT_NAMES = [
    "pelvis",
    "left_hip",
    "right_hip",
    "spine1",
    "left_knee",
    "right_knee",
    "spine2",
    "left_ankle",
    "right_ankle",
    "spine3",
    "left_foot",
    "right_foot",
    "neck",
    "left_collar",
    "right_collar",
    "head",
    "left_shoulder",
    "right_shoulder",
    "left_elbow",
    "right_elbow",
    "left_wrist",
    "right_wrist",
]

NUM_HML_JOINTS = len(HML_JOINT_NAMES)  # 22
HML_FEATURE_DIM = 263
# 4 root + 21*3 ric + 21*6 rot + 22*3 vel + 4 contacts == 263
assert 4 + 21 * 3 + 21 * 6 + 22 * 3 + 4 == HML_FEATURE_DIM

HML_LOWER_BODY_JOINTS = [
    HML_JOINT_NAMES.index(n)
    for n in [
        "pelvis", "left_hip", "right_hip", "left_knee", "right_knee",
        "left_ankle", "right_ankle", "left_foot", "right_foot",
    ]
]
HML_UPPER_BODY_JOINTS = [
    i for i in range(NUM_HML_JOINTS) if i not in HML_LOWER_BODY_JOINTS
]
HML_LOWER_BODY_RIGHT_JOINTS = [
    HML_JOINT_NAMES.index(n)
    for n in ["pelvis", "right_hip", "right_knee", "right_ankle", "right_foot"]
]
HML_PELVIS_FEET = [HML_JOINT_NAMES.index(n) for n in ["pelvis", "left_foot", "right_foot"]]
HML_PELVIS_HANDS = [HML_JOINT_NAMES.index(n) for n in ["pelvis", "left_wrist", "right_wrist"]]
HML_PELVIS_VR = [
    HML_JOINT_NAMES.index(n) for n in ["pelvis", "left_wrist", "right_wrist", "head"]
]


def _body_mask(joints_binary: np.ndarray, root_section: bool, contacts: bool) -> np.ndarray:
    return np.concatenate(
        [
            np.full(4, root_section),
            np.repeat(joints_binary[1:], 3),
            np.repeat(joints_binary[1:], 6),
            np.repeat(joints_binary, 3),
            np.full(4, contacts),
        ]
    )


_ROOT_BINARY = np.array([True] + [False] * (NUM_HML_JOINTS - 1))
HML_ROOT_MASK = _body_mask(_ROOT_BINARY, root_section=True, contacts=False)

_LOWER_BINARY = np.array([i in HML_LOWER_BODY_JOINTS for i in range(NUM_HML_JOINTS)])
HML_LOWER_BODY_MASK = _body_mask(_LOWER_BINARY, root_section=True, contacts=True)
HML_UPPER_BODY_MASK = ~HML_LOWER_BODY_MASK

_LOWER_RIGHT_BINARY = np.array(
    [i in HML_LOWER_BODY_RIGHT_JOINTS for i in range(NUM_HML_JOINTS)]
)
HML_LOWER_BODY_RIGHT_MASK = _body_mask(_LOWER_RIGHT_BINARY, root_section=True, contacts=True)

# Joint → feature correspondence matrices (22, 263), bool.
MAT_POS = np.zeros((NUM_HML_JOINTS, HML_FEATURE_DIM), dtype=bool)
MAT_POS[0, 1:4] = True
for j in range(1, NUM_HML_JOINTS):
    MAT_POS[j, 4 + 3 * (j - 1) : 4 + 3 * j] = True

MAT_ROT = np.zeros((NUM_HML_JOINTS, HML_FEATURE_DIM), dtype=bool)
MAT_ROT[0, 0] = True
for j in range(1, NUM_HML_JOINTS):
    MAT_ROT[j, 4 + 21 * 3 + 6 * (j - 1) : 4 + 21 * 3 + 6 * j] = True

MAT_VEL = np.zeros((NUM_HML_JOINTS, HML_FEATURE_DIM), dtype=bool)
for j in range(NUM_HML_JOINTS):
    MAT_VEL[j, 4 + 21 * 3 + 21 * 6 + 3 * j : 4 + 21 * 3 + 21 * 6 + 3 * (j + 1)] = True

MAT_CNT = np.zeros((NUM_HML_JOINTS, HML_FEATURE_DIM), dtype=bool)
MAT_CNT[7, -4] = True   # left ankle
MAT_CNT[10, -3] = True  # left foot
MAT_CNT[8, -2] = True   # right ankle
MAT_CNT[11, -1] = True  # right foot

# Trajectory-only model feature slice (root section).
TRAJ_FEATURE_DIM = 4
