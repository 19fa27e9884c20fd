"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers and the
plain PyTorch version of each. Nothing here is built at import: the
library is compiled by ``nvcc`` at the first kernel launch."""
