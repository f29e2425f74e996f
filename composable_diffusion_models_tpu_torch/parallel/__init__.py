"""Multi-rank execution on ``torch.distributed``: meshes, placements and
the expert-, data-, tensor-, pipeline- and sequence-parallel paths (port of
``composable_diffusion_models_tpu.parallel``)."""

from .mesh import (data_sharding, expert_sharding, make_mesh, replicate_pytree,
                   replicated, shard_batch, shard_pytree_leading)
from .sample import make_expert_parallel_eps_fn
from .tp import shard_unet_tp

__all__ = [
    "make_mesh", "data_sharding", "expert_sharding", "replicated",
    "shard_batch", "shard_pytree_leading", "replicate_pytree",
    "make_expert_parallel_eps_fn", "shard_unet_tp",
]
