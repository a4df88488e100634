from thormang_isaacgym_tpu_torch.models.robot import (  # noqa: F401
    DRIVE_EFFORT, DRIVE_NONE, DRIVE_POS, DRIVE_VEL,
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE,
    Geom, ModelParams, RobotModel,
)
from thormang_isaacgym_tpu_torch.models.urdf import load_urdf  # noqa: F401
from thormang_isaacgym_tpu_torch.models.allegro_hand import (  # noqa: F401
    ALLEGRO_DOF_NAMES, load_allegro_hand, make_allegro_urdf,
)
from thormang_isaacgym_tpu_torch.models.shadow_hand import (  # noqa: F401
    ACTUATED_DOF_NAMES, FINGERTIP_BODIES, load_shadow_hand, make_block_urdf,
    make_shadow_hand_urdf,
)
from thormang_isaacgym_tpu_torch.models.mjcf import load_mjcf  # noqa: F401
