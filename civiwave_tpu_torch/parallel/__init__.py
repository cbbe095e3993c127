"""Multi-device decomposition of the structured route over
``torch.distributed``: shard groups, slab/tile sharding, the counted
collectives and a launcher (``python -m civiwave_tpu_torch.parallel.launch``)."""
