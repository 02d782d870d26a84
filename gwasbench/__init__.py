"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 gwasbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is data found by name: ``configs/<config>.json``
(the deployment, its source, its cuts and its comparison limits),
``traffic/<traffic>.json`` (the seeded cohort's parameters),
``metrics/<metric>.py`` (one reader per metric) and
``kernels/<group>/*.txt`` (kernel-name patterns).  The yardstick lives
here too: the cohort generator (``cohort``), the cycled genotype source
(``source``), the float64 reference (``reference``), the comparison that
decides ``correct`` (``check``), the roofline arithmetic (``roofline``) and
the profiler arithmetic (``trace``).  Nothing here imports ``jax`` or the
JAX package ``repro``.
"""
