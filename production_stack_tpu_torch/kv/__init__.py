"""KV movement: the offload tiers and wire formats (:mod:`offload`) and
what an engine needs of the KV controller's hashing (:mod:`controller`).
The controller itself runs in the router."""
