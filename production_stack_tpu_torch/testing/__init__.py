"""The port's A/B harnesses (counterparts of
``production_stack_tpu/testing/spec_draft_ab.py`` and
``structured_ab.py``): each drives the port's own engine, or its own
server over a standard-library client, and prints one JSON line."""
