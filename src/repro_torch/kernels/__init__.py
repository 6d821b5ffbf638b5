"""Hand-written Hopper kernels of the PyTorch port (CUDA C++ sources in
``repro_torch/csrc``), each with its plain PyTorch version in ``ref``."""
