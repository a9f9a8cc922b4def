"""Reads a traffic mix (``mpcbench/traffic/<name>.json``): the keys every
mix has, and the keys of the loop that drives it.

A mix names its loop with ``loop``: the module ``mpcbench/loops/<loop>.py``
(``spec.loop``), which lists the further keys it requires (``KEYS``), may
give defaults for them (``DEFAULTS``) and may check their values
(``validate``); ``loops/__init__.py`` sets out the rest of what a loop
provides. The keys every mix has:

- ``lanes``: controllers solved together, one batch;
- ``commands_to_host``: ``every_tick`` (each tick ends when its commands are
  on the host: the robot's loop; each tick's latency is kept and the window
  ends with the tick that crosses ``--seconds``) or ``every_pass`` (the
  device is synchronised once at the end of a pass and the window ends with
  the round of passes that crosses it);

and, where the file leaves them out, those of :data:`DEFAULTS`:

- ``loop``: ``replay``, the recorded plant streams replayed open loop
  (``loops/replay.py``);
- ``trace_ticks``: ticks of each pass in the ``--trace 1`` window.
"""

from __future__ import annotations

import json
from pathlib import Path

from . import spec

KEYS = ("lanes", "commands_to_host")
DEFAULTS = dict(loop="replay", trace_ticks=40)


def load(path) -> dict:
    """The mix at ``path``: the file over its loop's defaults over
    :data:`DEFAULTS`, its keys checked."""
    raw = json.loads(Path(path).read_text())
    loop = spec.loop(raw.get("loop", DEFAULTS["loop"]))
    traffic = {**DEFAULTS, **getattr(loop, "DEFAULTS", {}), **raw}
    missing = [k for k in (*KEYS, *loop.KEYS) if k not in traffic]
    if missing:
        raise ValueError(f"{path}: missing {missing}")
    if traffic["commands_to_host"] not in ("every_tick", "every_pass"):
        raise ValueError(f"{path}: commands_to_host "
                         f"{traffic['commands_to_host']!r}")
    validate = getattr(loop, "validate", None)
    if validate is not None:
        validate(traffic, path)
    return traffic
