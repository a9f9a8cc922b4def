from .jet_lstm import LSTMJetModel  # noqa: F401
from .ekf import JetEKF, EKFState  # noqa: F401
from .plant import Plant, PlantState  # noqa: F401
