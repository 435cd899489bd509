"""The device mesh and the sharded eval and train steps: the names of
``xai_tpu.parallel``."""
from .mesh import make_mesh, replicate, shard_batch
from .sharded_eval import make_sharded_train_step, sharded_eval_step

__all__ = ["make_mesh", "shard_batch", "replicate", "sharded_eval_step",
           "make_sharded_train_step"]
