"""Multi-GPU layer of the port (port of dddpm_tpu/parallel/): the mesh
over torch.distributed ranks, the batch split, FSDP-style parameter
sharding, and a dry run of the sharded paths."""
