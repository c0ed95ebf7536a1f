"""The benchmark of the PyTorch and CUDA port (``probly_search_tpu_torch``):
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
See PERF.md for the cells, metrics and limits."""
