"""The paper's checksum algebra and the layer-level ABFT GEMM."""
