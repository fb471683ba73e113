"""The benchmark of ``metalrenderer_tpu_torch`` on one H100: ``run.py``
drives one cell of ``BENCHMARK.json``; ``configs/``, ``traffic/``,
``workloads/`` and ``metrics/`` hold each configuration, traffic mix, cell
and per-layer metric in a file of its own; ``reference/`` is the plain
reference that decides ``correct``."""
