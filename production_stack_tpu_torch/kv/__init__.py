"""KV movement: the offload tiers and wire formats (:mod:`offload`), the
device pipe between engine processes (:mod:`device_pipe`) and what an
engine needs of the KV controller's hashing (:mod:`controller`). The
controller itself runs in the router."""
