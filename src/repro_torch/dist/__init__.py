"""Distribution on a logical mesh: the sharding rules (`sharding`) and the
protected reductions over a stacked shard axis (`collectives`)."""
from repro_torch.dist import collectives, sharding
from repro_torch.dist.collectives import abft_psum, abft_psum_tree
from repro_torch.dist.sharding import (MODEL_AXIS, batch_specs, cache_specs,
                                       dp_axes, infer_param_specs,
                                       to_shardings, zero1_spec, zero_dim)

__all__ = ["sharding", "collectives", "abft_psum", "abft_psum_tree", "MODEL_AXIS",
           "dp_axes", "batch_specs", "infer_param_specs", "zero1_spec",
           "zero_dim", "cache_specs", "to_shardings"]
