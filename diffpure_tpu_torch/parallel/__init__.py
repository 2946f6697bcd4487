from diffpure_tpu_torch.parallel.mesh import Mesh, eot_fold, eot_unfold, \
    initialize_distributed, make_mesh, replicate, shard_batch
from diffpure_tpu_torch.parallel.serving import ShardedDefendedModel, shard_defended_call

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "eot_fold", "eot_unfold",
           "initialize_distributed", "shard_defended_call", "ShardedDefendedModel"]
