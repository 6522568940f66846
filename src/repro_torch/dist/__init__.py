"""Protected reductions over a stacked shard axis (`collectives`)."""
from repro_torch.dist.collectives import abft_psum, abft_psum_tree

__all__ = ["abft_psum", "abft_psum_tree"]
