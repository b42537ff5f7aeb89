"""The benchmark of ``pde_superresolution_torch`` on NVIDIA H100 cards.

``python3 -m port_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (``run.py``). The
harness is driven by data: a cell's configuration, traffic mix, route,
per-layer metrics and limits are files of their own, found by name
(``cells.py``). The yardstick lives here too: the input distributions
(``inputs.py``), the operations and bounds from shapes (``flops.py``), the
trace reading (``trace.py``), the plain reference (``reference/``) and the
comparison that decides ``correct`` (``compare.py``).
"""
