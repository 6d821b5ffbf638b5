"""The VFL system of the PyTorch port: matching, protocols, the driver
and the agent runtime, mirroring the JAX package's ``repro.core``."""
