"""Building and loading the port's hand-written CUDA kernels."""
