"""Hand-written CUDA kernels of the port (one subpackage per kernel family)."""
