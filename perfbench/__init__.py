"""The benchmark of metatts_torch, the PyTorch and CUDA port, on the H100.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Nothing here
imports JAX or the JAX package; ``reference/`` imports nothing of the port.
"""
