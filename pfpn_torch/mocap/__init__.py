from .loader import MotionData, load_motion  # noqa: F401
from .motion import MotionPose, apply_base_offset, sample_pose, sync_position_offset  # noqa: F401
