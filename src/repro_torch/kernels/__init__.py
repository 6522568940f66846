"""Hand-written Hopper kernels, their plain PyTorch versions, and the
dispatchers that pick a tiling and call them."""
