"""Multi-process sharding of the PyTorch port: the shard runner and the
mesh map on torch.distributed."""
