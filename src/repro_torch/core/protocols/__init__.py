from repro_torch.core.protocols.base import (PROTOCOLS,  # noqa: F401
                                             VFLConfig, register,
                                             resolve_protocol)
from repro_torch.core.protocols.driver import (  # noqa: F401
    Callback, Checkpointer, Driver, EarlyStopping, EvalEveryEpoch,
    MetricsStream, StopAtStep, VFLProtocol)
