"""The benchmark of ``reze_tpu_torch`` on one NVIDIA H100.

``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON line
(:mod:`portbench.harness`). Everything that belongs to one configuration,
traffic mix or metric is a file of its own, found by the name the manifest
gives it:

* ``configs/<config>.json``: the configuration as it is run (the scene,
  the ``EngineConfig`` fields, the driver that runs it, the limits of the
  output check);
* ``traffic/<traffic>.json``: the traffic's parameters, read by the
  configuration's driver, and ``check_calls``, which every traffic file
  gives: the number of kept window calls the check replays, read by the
  harness (:func:`portbench.check.choose`);
* ``drivers/<driver>.py``: how one kind of entry point is set up, warmed
  up, driven through the window and replayed on the reference;
* ``metrics/<metric>.py``: ``read(run) -> float | None``, the metric from
  the run's clocks, spans, counters and device trace.

The yardstick lives here too: the seeded scene (``scene/``, a frozen
copy of the port's generator), the plain reference (``reference/``, a
frozen copy of the port's plain torch path, importing nothing of the
port), the comparison that decides ``correct`` (:mod:`portbench.check`),
the trace reduction (:mod:`portbench.trace`) and the roofline's peaks and
byte counts (:mod:`portbench.roofline`).
"""
