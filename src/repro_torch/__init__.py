"""PyTorch/CUDA port of the ``repro`` GWAS scan (see README, "PyTorch / CUDA port").

Subpackages mirror ``repro``: ``io`` (genotype/phenotype readers), ``kernels``
(hand-written CUDA kernels and their plain PyTorch versions), ``core``
(statistics, residualization, engines, sinks), ``runtime`` (planners,
prefetch, checkpoints), ``api`` (Study -> plan -> session -> writers),
``launch`` (the ``gwas`` CLI), ``serve`` (the scan service), and the LM
wing's serving path: ``configs`` (the architecture zoo), ``models`` and
``train`` (``build_prefill_step`` / ``build_decode_step``).  The package
imports ``torch`` and ``numpy`` only; it never imports JAX or the ``repro``
package.
"""

__version__ = "0.1.0"
