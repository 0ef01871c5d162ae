"""Hand-written CUDA kernels, their plain PyTorch versions, and the flat
tile-plane layout they run over."""
