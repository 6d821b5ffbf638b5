"""Federated serving for the PyTorch port. Unlike the JAX package's
``repro.serve`` this imports no LLM engine: the port has none yet."""
from repro_torch.serve.federated import (AdmissionError,  # noqa: F401
                                         FederatedServer, ServeCfg,
                                         ServeClient, ServeFrontend,
                                         ServeStats)
