"""Several devices: hash-space shards in one process (``sharded``) and
one process a host under torch.distributed (``multihost``)."""
