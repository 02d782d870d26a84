"""PyTorch/CUDA port of the ``repro`` GWAS scan (see README, "PyTorch / CUDA port").

Subpackages mirror ``repro``: ``io`` (genotype/phenotype readers), ``kernels``
(hand-written CUDA kernels and their plain PyTorch versions), ``core``
(statistics, residualization, engines, sinks), ``runtime`` (planners,
prefetch, checkpoints), ``api`` (Study -> plan -> session -> writers) and
``launch`` (the ``gwas`` CLI).  The package imports ``torch`` and ``numpy``
only; it never imports JAX or the ``repro`` package.
"""

__version__ = "0.1.0"
