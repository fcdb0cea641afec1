"""Device meshes for one process that drives several devices
(port of ``skoots_tpu/parallel``): :mod:`.mesh` lays a ``[data, space]``
grid over ``torch.device``s and splits tensors over it; :mod:`.distributed`
is the multi-process bootstrap (``torch.distributed``)."""

from skoots_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    replicated,
    spatial_sharding,
)

__all__ = ["Mesh", "make_mesh", "batch_sharding", "replicated", "spatial_sharding"]
