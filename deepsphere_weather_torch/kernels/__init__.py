"""Hand-written CUDA kernels of the port and their build (see build.py)."""
