from thormang_isaacgym_tpu_torch.models.robot import (  # noqa: F401
    DRIVE_EFFORT, DRIVE_NONE, DRIVE_POS, DRIVE_VEL,
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE,
    Geom, ModelParams, RobotModel,
)
from thormang_isaacgym_tpu_torch.models.urdf import load_urdf  # noqa: F401
