"""Distribution: the sharded containers over ``torch.distributed``.

Counterpart of ``spmv_tpu/dist/``. Each rank is one process that owns one
device (NCCL between CUDA cards, gloo between CPU processes). A rank
builds the port's own container from its slab of the triplets, so every
shard runs the engine kernels of the single-device containers, and the
collectives of ``mesh`` join the shards' outputs:

* ``sharded.RowShardedSpmv``: row slabs, x all-gathered (or given whole);
* ``sharded.ColShardedSpmv``: column slabs, the partial y summed;
* ``ring.RingShardedSpmv``: row slabs × column blocks, x blocks passed
  round a ring;
* ``overlap.ChunkedRowSpmv``: the row form with x gathered in chunks, each
  chunk's gather in flight during the previous chunk's multiply.
"""

from spmv_tpu_torch.dist.mesh import Mesh, init_distributed, make_mesh

__all__ = ["Mesh", "init_distributed", "make_mesh"]
