"""Plain PyTorch and NumPy reference of the benchmarked model."""
