"""The plain reference: float32 PyTorch forward passes written from the
published model descriptions. Imports nothing of the port."""
