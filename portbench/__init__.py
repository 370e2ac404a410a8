"""The benchmark of the PyTorch and CUDA port (``the_algorithm_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card it starts on. What
belongs to one configuration, traffic mix, driver or per-layer metric sits in
a file of its own (``configs/``, ``traffic/``, ``drivers/``, ``metrics/``,
``limits/``), found by the name ``BENCHMARK.json`` gives it. The yardstick
(input generators, byte arithmetic, peaks, the plain references and
the comparison that decides ``correct``) lives here too and imports nothing
of the port; only the drivers touch the port, through its public builders.
"""
