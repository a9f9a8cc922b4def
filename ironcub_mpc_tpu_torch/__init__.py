"""ironcub_mpc_tpu_torch — the condensed multi-rate MPC of ``ironcub_mpc_tpu``
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The layout mirrors the JAX package so each counterpart is found by name:

- ``core``     state layout, configuration tree (copied numpy-only modules)
               and the tensor containers of the tick.
- ``horizon``  the variable-sampling-time schedule (copied, numpy-only).
- ``ops``      SO(3)/RPY algebra, the jet polynomial, solver settings and
               the three CUDA kernels (``csrc/``) with their launch plans
               and plain PyTorch twins.
- ``qp``       linearisation, condensing, the box-QP solve and the tick.
- ``dynamics`` kinodynamics of the reduced URDF model and the wrenches.
- ``sim``      the 1 kHz rigid-body plant with LSTM+EKF jets.
- ``runtime``  the recorded-flight replay loader, the mission trajectories,
               the closed loop and the flight runner.
- ``convert``  state carried across from the JAX package as numpy arrays.

Functions take tensors with a leading batch dimension (one lane per
scenario) where the JAX package is ``vmap``-ed. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# Control-grade linear algebra: IEEE fp32 in every matmul, never TF32 (the
# JAX package pins "highest" for the same reason — the flight state blew up
# under reduced-precision matmuls, README "No reduced-precision linear
# algebra").
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> _torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Never falls back to the CPU on its own."""
    dev = _torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "ironcub_mpc_tpu_torch runs on cuda by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev
