"""PyTorch engine: core, scheduler, sampling and the OpenAI server."""
