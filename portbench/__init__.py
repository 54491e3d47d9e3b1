"""The benchmark of the PyTorch and CUDA port, ``optimal_control_paradiag_torch``.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on one card and prints one JSON
line. Everything that belongs to one configuration, one traffic mix, one
cell or one metric is a file of its own, found by its name
(``manifest.py``); see ``README.md``.
"""
