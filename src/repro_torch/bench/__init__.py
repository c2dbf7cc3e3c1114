"""Benchmarks of the port (``python -m repro_torch.bench.run``): the
twins of the reference's ``benchmarks/`` — the analyzer's scaling grid
(:mod:`.analyzer_bench`), the kernels beside their plain versions and
library calls (:mod:`.kernel_bench`) and the paper's tables and figures
(:mod:`.paper_tables`)."""
