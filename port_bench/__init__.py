"""The benchmark of the PyTorch and CUDA package ``dvis_plus_tpu_torch``.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON result line last.
"""
