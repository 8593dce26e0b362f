"""Hand-written CUDA kernels, their plain versions, and dispatch."""
