"""Geometry: rotation conversions, quaternions, BVH IO, face blendshapes.

Counterpart of ``diffsheg_tpu/geometry``: the conversions are torch and
run on any device (the export's runs on the card); BVH text IO, forward
kinematics, the joint tables and the face JSON are the port's own numpy
copies.
"""

from diffsheg_tpu_torch.geometry.rotations import (  # noqa: F401
    axis_angle_to_euler,
    axis_angle_to_matrix,
    axis_angle_to_quaternion,
    euler_to_axis_angle,
    euler_to_matrix,
    matrix_to_axis_angle,
    matrix_to_euler,
    matrix_to_quaternion,
    quaternion_to_axis_angle,
    quaternion_to_matrix,
)
from diffsheg_tpu_torch.geometry.joints import (  # noqa: F401
    BEAT_CHANNELS,
    BEAT_JOINT_ORDER,
    BEAT_TOTAL_CHANNELS,
    SPINE_NECK_141_IN_BEAT,
    SPINE_NECK_141_ORDER,
    SPINE_NECK_DIM,
    scatter_subset_into_full,
    subset_channel_indices,
)
from diffsheg_tpu_torch.geometry.bvh import (  # noqa: F401
    BvhData,
    BvhJoint,
    forward_kinematics,
    parse_bvh,
    parse_bvh_file,
    rewrite_template,
    rewrite_template_file,
    write_bvh,
)
from diffsheg_tpu_torch.geometry.face import (  # noqa: F401
    ARKIT_FACIAL_51,
    read_face_json,
    write_face_json,
)
