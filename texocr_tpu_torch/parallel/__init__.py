"""The data x model process mesh: data parallelism over processes, tensor
parallelism of the attention, MLP and vocabulary matrices over a 'model'
axis, with explicit collectives (``parallel/layers.py``)."""

from texocr_tpu_torch.parallel.mesh import MeshAxis, create_mesh, mesh_axis  # noqa: F401
from texocr_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_rows,
    gather_state_dict,
    param_partition_spec,
    shard_state_dict,
)
