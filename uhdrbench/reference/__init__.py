"""The plain reference of the benchmark: NumPy and PyTorch only.  It
imports neither JAX nor either codec package."""
