"""Serving for the PyTorch port: the model zoo's batched engine and the
federated server."""
from repro_torch.serve.engine import ServeEngine  # noqa: F401
from repro_torch.serve.federated import (AdmissionError,  # noqa: F401
                                         FederatedServer, ServeCfg,
                                         ServeClient, ServeFrontend,
                                         ServeStats)
