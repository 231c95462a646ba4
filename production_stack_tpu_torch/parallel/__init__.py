"""Tensor parallelism across ranks: the sharding rules, the rank layout,
the multi-process bring-up with its op channel, and the collectives of a
sharded forward."""
