"""Multi-process communicator (the paper's third execution mode).

One ``multiprocessing.Queue`` mailbox per agent; messages are the codec
blobs (bytes pickle cheaply and keep payload accounting identical to the
other modes). Agent functions must be module-level picklables.

Shares the mailbox drain/reorder logic with the thread transport; the
async sender engine (isend futures) runs per process, so a member's
wire writes overlap its jax/HE compute with true parallelism here —
this is the mode where pipelined VFL escapes the GIL entirely.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
from typing import Dict, Sequence, Tuple

from repro_torch.comm.base import Message
from repro_torch.comm.local import _MailboxCommunicator


class ProcessBus:
    def __init__(self, world: Sequence[str], ctx=None):
        self.world = list(world)
        ctx = ctx or mp.get_context("spawn")
        self.boxes: Dict[str, mp.Queue] = {w: ctx.Queue() for w in world}

    def communicator(self, me: str, timeout: float = 240.0,
                     comm_cfg=None) -> "ProcessCommunicator":
        return ProcessCommunicator(me, self, timeout=timeout,
                                   comm_cfg=comm_cfg)


class ProcessCommunicator(_MailboxCommunicator):
    def __init__(self, me: str, bus: ProcessBus, timeout: float = 240.0,
                 comm_cfg=None):
        super().__init__(me, bus.world, timeout=timeout,
                         comm_cfg=comm_cfg)
        self._boxes = bus.boxes
        self._pending: Dict[Tuple[str, str], list] = {}

    def _send(self, msg: Message, raw: bytes) -> None:
        self._boxes[msg.recipient].put(raw)

    def _box_get(self, timeout: float) -> bytes:
        try:
            return self._boxes[self.me].get(timeout=max(timeout, 1e-4))
        except queue.Empty:
            raise TimeoutError(f"{self.me}: mailbox empty") from None
