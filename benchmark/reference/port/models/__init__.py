from benchmark.reference.port.models.robot import (  # noqa: F401
    DRIVE_EFFORT, DRIVE_NONE, DRIVE_POS, DRIVE_VEL,
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE,
    Geom, ModelParams, RobotModel,
)
from benchmark.reference.port.models.urdf import load_urdf  # noqa: F401
from benchmark.reference.port.models.shadow_hand import (  # noqa: F401
    ACTUATED_DOF_NAMES, FINGERTIP_BODIES, load_shadow_hand, make_block_urdf,
    make_shadow_hand_urdf,
)
from benchmark.reference.port.models.mjcf import load_mjcf  # noqa: F401
