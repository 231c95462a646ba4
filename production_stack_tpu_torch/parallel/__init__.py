"""Parallelism across ranks: the sharding rules, the rank layout, the
multi-process bring-up with its op channel, the collectives of a
tensor-parallel forward, the point-to-point transfers and GPipe schedule
of a pipeline-parallel one, ring attention, and a rank's part of a KV
block (:mod:`kv_blocks`)."""
