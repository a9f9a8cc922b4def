from . import jet_model  # noqa: F401
from . import so3  # noqa: F401
