"""Runnable examples of the PyTorch port, each a module:
``python -m repro_torch.examples.<name>``."""
