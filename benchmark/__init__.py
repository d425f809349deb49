"""The benchmark of ``lpe_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell once, from the root of a checkout::

    python -m benchmark.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Everything a cell needs is found by name (``BENCHMARK.json`` at the root
names each cell's configuration and traffic):

- ``benchmark/configs/<config>.json``: the configuration as it is run;
  its ``kind`` names the scene module ``benchmark/scenes/<kind>.py`` and
  the plain reference ``benchmark/reference/<kind>.py``;
- ``benchmark/traffic/<traffic>.json``: the parameters that the one
  traffic loop in ``harness.py`` reads (the entry, ticks a block);
- ``benchmark/workloads/<cell>.json``: the cell's own settings: the
  limits of its output check, and where ``harness.DEFAULTS`` do not suit
  it, the blocks it warms, checks and traces;
- ``benchmark/metrics/<metric>.py``: one reader a per-layer metric, which
  takes its number from the traced window (``trace.Trace``) and returns
  None where it finds nothing to read. A metric named ``<metric>.<group>``
  (one quantity reported apart for a group of cells, such as
  ``device_idle_share.host_paced``) is read by ``metrics/<metric>.py``.

Nothing here imports ``jax`` or the JAX package ``lpe_tpu``; the plain
references import nothing of ``lpe_tpu_torch`` either.
"""
