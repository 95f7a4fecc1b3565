"""Multi-rank execution over ``torch.distributed`` (counterpart of
``pymra_tpu/parallel``): named meshes, the leaf- and critDepth-sharded
sweep, and chains over ranks."""
from pymra_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    make_mesh,
    make_multihost_mesh,
)
from pymra_torch.parallel.sharded import (
    pad_plan_for_sharding,
    sharded_loglik_fn,
    sharded_sweep,
)

__all__ = [
    "make_mesh",
    "make_multihost_mesh",
    "initialize_distributed",
    "Mesh",
    "pad_plan_for_sharding",
    "sharded_sweep",
    "sharded_loglik_fn",
]
