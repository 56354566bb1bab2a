"""Hand-written CUDA kernels of the crossbar datapath and their wrappers."""
