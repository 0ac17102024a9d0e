"""The benchmark of the PyTorch and CUDA port (``spaln_tpu_torch``) on one
H100: ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.  See ``BENCHMARK.json`` and ``benchmark.harness``."""
