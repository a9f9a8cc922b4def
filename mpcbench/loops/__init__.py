"""The loops that drive the benchmark's traffic mixes, a file each.

A mix names its loop with ``"loop": "<name>"`` (``replay`` where it names
none), and ``spec.loop`` loads ``loops/<name>.py`` by its path, as it loads
a metric's reader: a loop imports the harness by absolute names (``from
mpcbench.core import port``), and the program (``ironcub_mpc_tpu_torch``)
only inside its functions. A loop module provides:

- ``KEYS``: the mix keys it requires besides those every mix has
  (``core/traffic.py``); where it needs them, ``DEFAULTS`` for its own keys
  and ``validate(traffic, path)``, which raises ``ValueError``;
- ``Loop(cell, seed)``, its set-up: it builds the program's objects (and,
  on a card, the kernels it names, ``port.build_kernels``), loads its data
  files under ``mpcbench/streams/``, configures, and runs its lead-in and
  warm passes. ``cell`` is the driver's ``Cell`` with the spec read:
  ``config``, ``config_path``, ``traffic`` (overrides applied), ``dev``,
  ``lanes``, ``per_tick``. The object has:

  - ``passes``: the names of its passes, which the window runs in turn;
  - ``run_pass(name, records, statuses, n_ticks=None, latencies=None,
    deadline=None, span=None)``: one pass, or its first ``n_ticks`` ticks.
    Each tick appends one record and its solver statuses [lanes] and, with
    ``latencies``, the seconds between the two ``time.perf_counter`` reads
    around it. It returns False where ``cell.per_tick`` holds and a tick
    ended past ``deadline``. ``span(name)`` opens a host span of the
    harness's own (``trace.SPANS``) in a traced run, and is
    ``driver.NOSPAN`` otherwise;
  - ``lead_in_status``: {name: [statuses [lanes]]} of the ticks set-up ran
    from a cold controller, outside the window, shown beside the result;
  - ``check(records, statuses, detail)``: once the window has closed and
    its peak memory is read, frees the program's state, runs the reference
    and returns the candidate numbers {name: value}, ``nonfinite`` among
    them (checked outputs that are not finite). ``detail``, where not None,
    receives what a calibration reads.

The driver keeps what every loop shares: the spec, the measured window
(``driver.measure``), the traced window (profiler, counters, kernel calls
and the readers' context), the device, ``attempted`` and ``failed`` from
the statuses, the judgement of the numbers against
``cells/<workload>.json`` and the result line.

A closed-loop mix, the paper's simulated flight, takes the same shape:

- set-up builds ``runtime/loop.py``'s ``ClosedLoop`` over its plant from
  the configuration and loads its starting states from ``streams/``, each
  a plant state, a controller carry and the plant's sensor-noise generator
  state (``Plant.noise_state``); each pass restores them by device copies
  (the generator by ``Plant.set_noise_state``);
- a tick is ``ClosedLoop.tick``: the snapshot, an ``mpc_tick``, the
  commands applied and five 1 kHz plant substeps; its records hold the
  commands and the plant state;
- its check steps a reference of its own under ``mpcbench/reference/``
  (the plant in float64, no program code) from the recorded states;
- it names the kernels it builds.
"""
