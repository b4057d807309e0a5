"""Serving over a pp × tp mesh of processes (``--mesh``) on
``torch.distributed``."""

from .balance import layer_costs, plan_stages, stage_spans
from .dist import init_from_env, initialize
from .engine import ShardedEngine
from .mesh import Mesh, MeshSpec
from .pipeline import (CHUNK, make_sharded_cache, pipeline_forward, shard_model_params,
                       validate_mesh)

__all__ = ["CHUNK", "Mesh", "MeshSpec", "ShardedEngine", "init_from_env",
           "initialize", "layer_costs", "make_sharded_cache", "pipeline_forward",
           "plan_stages", "shard_model_params", "stage_spans", "validate_mesh"]
