"""The multi-robot parallel tier on torch.distributed — port of
``coxgraph_tpu.parallel``: SPMD fleet integration and the distributed
pose-graph solve (``fleet``), the slab-sharded ESDF (``esdf_sharded``),
the sharded global merge and mesh (``merge_sharded``) and multi-process
bring-up (``multihost``), over the process mesh and collectives of
``collectives``."""
