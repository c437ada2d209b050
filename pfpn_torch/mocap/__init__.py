from .loader import MotionData, load_motion  # noqa: F401
from .motion import (MotionPose, apply_base_offset, mirror_pose, sample_pose,  # noqa: F401
                     sync_position_offset)
