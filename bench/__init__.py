"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything the yardstick needs lives here: the graph
generator and the packed layout (``graphs``), the weights (``weights``),
the plain reference of each configuration (``reference/``), the work
counters (``work/``), the table of peaks (``peaks``), the profiler
reduction (``trace``), one reader a per-layer metric (``metrics/``) and
one loop a kind of traffic (``loops/``). A configuration, a traffic
mix or a metric is found by its name in ``BENCHMARK.json``; nothing here
imports ``jax`` or the JAX package ``repro``.
"""
