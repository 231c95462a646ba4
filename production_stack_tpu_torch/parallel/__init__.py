"""Parallelism across ranks: the sharding rules, the rank layout, the
multi-process bring-up with its op channel, the collectives of a
tensor-parallel forward, the point-to-point transfers and GPipe schedule
of a pipeline-parallel one, and ring attention."""
