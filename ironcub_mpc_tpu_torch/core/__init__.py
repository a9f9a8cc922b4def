from . import constants  # noqa: F401
from .config import (  # noqa: F401
    MPCConfig,
    RobotConfig,
    SimConfig,
    joint_selector,
    mpc_config_from_xml,
    robot_config_from_toml,
    sim_config_from_toml,
)
