"""The benchmark of ``repro_torch``, the PyTorch/CUDA port.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see README.md.
"""
