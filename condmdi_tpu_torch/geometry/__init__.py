from condmdi_tpu_torch.geometry.quaternion import (
    qinv,
    qnormalize,
    qmul,
    qrot,
    qfix,
    qbetween,
    qslerp,
    quaternion_to_matrix,
    quaternion_to_cont6d,
    cont6d_to_matrix,
)
from condmdi_tpu_torch.geometry.rotations import (
    rotation_6d_to_matrix,
    matrix_to_rotation_6d,
    matrix_to_quaternion,
    axis_angle_to_quaternion,
    quaternion_to_axis_angle,
    axis_angle_to_matrix,
    matrix_to_axis_angle,
    euler_angles_to_matrix,
    matrix_to_euler_angles,
    standardize_quaternion,
)
from condmdi_tpu_torch.geometry.skeleton import Skeleton, T2M_RAW_OFFSETS, T2M_KINEMATIC_CHAIN
