from .model import RobotModel  # noqa: F401
from .ironcub_model import build_ironcub_model, load_ironcub_model  # noqa: F401
from .kinodynamics import KinDyn, compute_snapshot  # noqa: F401
