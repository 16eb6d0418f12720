"""The benchmark of the PyTorch and CUDA port (``pathtrace_tpu_torch``):
``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  ``BENCHMARK.json`` at the checkout's root names the
cells; each configuration, traffic mix, per-layer metric and frozen work
count is a file of its own here, found by its name."""
