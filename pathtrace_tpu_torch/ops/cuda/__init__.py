"""CUDA C++ kernels for Hopper (sources in ``pathtrace_tpu_torch/csrc``), their
build, and their plain PyTorch versions."""
