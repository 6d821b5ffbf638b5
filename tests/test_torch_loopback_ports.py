"""The port's loopback addresses (``comm/sock.py`` ``local_addresses``):
each port is drawn below the kernel's ephemeral range, so another
process's port-0 bind or outgoing connection cannot take it between the
draw and the communicator's bind."""
import socket

import pytest

pytest.importorskip("torch")

from repro_torch.comm import sock  # noqa: E402


def test_ports_are_distinct_and_below_the_ephemeral_range():
    lo, hi = sock.ephemeral_range()
    assert 1024 <= lo <= hi
    world = [f"p{i}" for i in range(16)]
    for _ in range(8):
        addrs = sock.local_addresses(world)
        ports = [port for _, port in addrs.values()]
        assert list(addrs) == world
        assert len(set(ports)) == len(ports)
        assert all(1024 <= port < lo for port in ports), (ports, lo)
        # each is free: a listener binds it
        for _, port in addrs.values():
            s = socket.socket()
            s.bind(("127.0.0.1", port))
            s.close()


def test_a_base_port_is_kept():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    assert sock.local_addresses(["a", "b"], base_port=port) == {
        "a": ("127.0.0.1", port), "b": ("127.0.0.1", port)}
