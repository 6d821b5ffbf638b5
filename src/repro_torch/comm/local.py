"""In-process thread-based communicator (the paper's local debug mode).

A shared :class:`ThreadBus` holds one mailbox per agent; messages go
through the safetensors codec round-trip anyway so payload sizes and
(de)serialization behaviour match the distributed modes exactly — only
the transport differs. This is what makes "debug in the IDE, deploy on
the cluster" seamless.

Delivery is mailbox-ordered: ``_recv_any`` drains the agent's queue
into per-(sender, tag) pending lists until a wanted tag shows up, so
out-of-order tags (async frames racing data messages) are parked, not
lost. One consumer thread per agent is assumed (the driver model).
"""
from __future__ import annotations

import queue
import time
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.comm import codec
from repro_torch.comm.base import Message, PartyCommunicator


class ThreadBus:
    def __init__(self, world: Sequence[str]):
        self.world = list(world)
        self._boxes: Dict[str, "queue.Queue[bytes]"] = {
            w: queue.Queue() for w in world}

    def communicator(self, me: str, timeout: float = 120.0,
                     comm_cfg=None) -> "ThreadCommunicator":
        return ThreadCommunicator(me, self, timeout=timeout,
                                  comm_cfg=comm_cfg)


class _MailboxCommunicator(PartyCommunicator):
    """Shared drain logic for queue-mailbox transports (thread + mp)."""

    def _box_get(self, timeout: float):
        raise NotImplementedError

    def _decode_one(self, raw: bytes) -> Message:
        payload, meta = codec.decode(raw)
        sender = meta.pop("sender")
        tag = meta.pop("tag")
        return Message(sender, self.me, tag, payload, meta)

    def _pop_pending(self, key) -> Optional[Message]:
        lst = self._pending.get(key)
        if not lst:
            return None
        msg = lst.pop(0)
        if not lst:                 # keyed by stepped tags: delete on
            del self._pending[key]  # drain or a long fit leaks entries
        return msg

    def _recv_any(self, frm: str, tags: Sequence[str],
                  timeout: Optional[float] = None) -> Message:
        timeout = self._timeout if timeout is None else timeout
        keys = [(frm, t) for t in tags]
        deadline = time.monotonic() + timeout
        while True:
            for key in keys:
                msg = self._pop_pending(key)
                if msg is not None:
                    return msg
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{self.me}: no message "
                                   f"{frm}/{list(tags)}")
            msg = self._decode_one(self._box_get(left))
            if (msg.sender, msg.tag) in keys:
                return msg
            self._pending.setdefault((msg.sender, msg.tag),
                                     []).append(msg)

    def _peek(self, frm: str, tags: Sequence[str]) -> bool:
        # single-consumer: safe to opportunistically drain the mailbox
        while True:
            try:
                raw = self._box_get(0.0)
            except (queue.Empty, TimeoutError):
                break
            msg = self._decode_one(raw)
            self._pending.setdefault((msg.sender, msg.tag),
                                     []).append(msg)
        return any(self._pending.get((frm, t)) for t in tags)


class ThreadCommunicator(_MailboxCommunicator):
    def __init__(self, me: str, bus: ThreadBus, timeout: float = 120.0,
                 comm_cfg=None):
        super().__init__(me, bus.world, timeout=timeout,
                         comm_cfg=comm_cfg)
        self._bus = bus
        self._pending: Dict[Tuple[str, str], list] = {}

    def _send(self, msg: Message, raw: bytes) -> None:
        self._bus._boxes[msg.recipient].put(raw)

    def _box_get(self, timeout: float) -> bytes:
        try:
            return self._bus._boxes[self.me].get(
                timeout=max(timeout, 1e-4))
        except queue.Empty:
            raise TimeoutError(f"{self.me}: mailbox empty") from None
