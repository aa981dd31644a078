"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its plain
PyTorch version beside it. Nothing is built or loaded at import: the CUDA
libraries are compiled on first use (``build.py``)."""
