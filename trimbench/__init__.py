"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 trimbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints one JSON line.  Each configuration, traffic mix, graph generator
and per-layer metric is a file of its own under this folder, found by
the name ``BENCHMARK.json`` gives it (``spec.py``).
"""
