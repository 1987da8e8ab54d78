"""Kinematics: rotation math, SE(3) and tree operations, the SMPL body
model (counterpart of `mobileposer_tpu/kinematics/`)."""

from mobileposer_tpu_torch.kinematics.rotation import (  # noqa: F401
    RotationRepresentation,
    angle_between,
    angle_difference,
    axis_angle_to_quaternion,
    axis_angle_to_rotation_matrix,
    degree_to_radian,
    euler_angle_to_rotation_matrix,
    generate_random_rotation_matrix,
    lerp,
    normalize_angle,
    normalize_tensor,
    quaternion_to_axis_angle,
    quaternion_to_rotation_matrix,
    r6d_to_rotation_matrix,
    radian_to_degree,
    rotation_matrix_to_axis_angle,
    rotation_matrix_to_euler_angle,
    rotation_matrix_to_quaternion,
    rotation_matrix_to_r6d,
    svd_rotate,
    to_rotation_matrix,
    vector_cross_matrix,
)
from mobileposer_tpu_torch.kinematics.spatial import (  # noqa: F401
    bone_vector_to_joint_position,
    decode_transformation_matrix,
    forward_kinematics,
    forward_kinematics_R,
    forward_kinematics_T,
    inverse_kinematics_R,
    inverse_kinematics_T,
    inverse_transformation_matrix,
    joint_position_to_bone_vector,
    joint_positions_from_global,
    transformation_matrix,
)
from mobileposer_tpu_torch.kinematics.smpl import (  # noqa: F401
    NUM_JOINTS,
    NUM_VERTICES,
    SMPL_PARENTS,
    SMPLJoint,
    ParametricModel,
    load_smpl_arrays,
    synthetic_smpl_arrays,
)
