#!/usr/bin/env python
"""Write the calibrated iRonCub-Mk3 URDF from the PyTorch port's copy of the
procedural model (counterpart of tools/make_calibrated_urdf.py).

The model (``ironcub_mpc_tpu_torch/dynamics/ironcub_model.py``) is authored
rooted at ``root_link``, the convention of the real asset
(configMujoco.toml:2), so loading the file exercises the reduction and
re-rooting of ``load_urdf(path, axesList, "chest")``. The output is
byte-identical to the committed ``data/ironcub_mk3_calibrated.urdf`` while
the port's copy of the model matches the JAX package's.

Usage: python tools/make_calibrated_urdf_torch.py
           [--out ironcub_mk3_calibrated_torch.urdf]

Writes ``--out`` (a new file by default) and never into ``data/``: the
committed URDF is regenerated by the JAX tool only.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from common_torch import option, writable  # noqa: E402

DEFAULT_OUT = "ironcub_mk3_calibrated_torch.urdf"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    out = writable(option(argv, "out", DEFAULT_OUT))

    from ironcub_mpc_tpu_torch.dynamics.ironcub_model import (
        TOTAL_MASS_KG, build_ironcub_model)
    from ironcub_mpc_tpu_torch.dynamics.urdf_export import model_to_urdf

    model = build_ironcub_model()
    assert abs(model.total_mass - TOTAL_MASS_KG) < 1e-9, model.total_mass
    xml = model_to_urdf(model, "root_link",
                        robot_name="iRonCub-Mk3-calibrated")
    out.write_text(xml)
    print(f"wrote {out}: {model.n_links} links, {model.n_joints} joints, "
          f"{model.total_mass:.1f} kg")
    return out


if __name__ == "__main__":
    main()
