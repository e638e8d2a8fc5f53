"""Rank-mesh parallelism on ``torch.distributed``: shot sharding of every
objective family, spatial domain decomposition with a halo exchange, and
both at once (port of ``devito_fwi_tpu.parallel``)."""
from .sharding import shot_mesh, fm_multi_sharded, fwi_obj_sharded

__all__ = ["shot_mesh", "fm_multi_sharded", "fwi_obj_sharded"]
