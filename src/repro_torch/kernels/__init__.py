"""Hand-written Hopper kernels, their plain PyTorch versions, and the
dispatchers that pick a tiling and call them."""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.abft_matmul import (abft_matmul_acc_cuda,
                                             abft_matmul_cuda)
from repro_torch.kernels.checksum_encode import checksum_encode_cuda
