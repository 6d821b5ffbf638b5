from repro_torch.comm.base import (Message, PartyCommunicator,  # noqa: F401
                                   CommCfg, CommStats, LinkSpec,
                                   RecvFuture, SendFuture)
from repro_torch.comm.local import ThreadBus, ThreadCommunicator  # noqa: F401
from repro_torch.comm.schema import (Field, MsgType, SchemaError,  # noqa: F401
                                     TypedChannel, message)
