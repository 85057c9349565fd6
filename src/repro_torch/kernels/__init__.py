"""Hand-written CUDA kernels, their plain versions and the backend registry."""
