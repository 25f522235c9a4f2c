"""chip_smoke.py's port chooser (free_port), on the CPU.

Every listener the script starts takes its port from free_port, which
draws from a generator seeded with a constant and the pid below Linux's
ephemeral range
(/proc/sys/net/ipv4/ip_local_port_range, from which every bind(0) and
outgoing connect() on the host takes its port) and above 1024, checks
that the port binds, and never returns one twice in a run."""

import random
import socket

import pytest

import chip_smoke


@pytest.fixture
def fresh_chooser(monkeypatch):
    """A chooser with the script's seed and no port chosen yet."""
    monkeypatch.setattr(chip_smoke, "_port_rng",
                        random.Random(chip_smoke.PORT_SEED))
    monkeypatch.setattr(chip_smoke, "_ports_chosen", set())


def test_ports_are_distinct_below_the_ephemeral_range_and_bind(
        fresh_chooser):
    lo, hi = chip_smoke.local_port_range()
    assert 1024 < lo <= hi
    ports = [chip_smoke.free_port() for _ in range(200)]
    assert len(set(ports)) == len(ports)
    assert all(1024 < p < lo for p in ports)
    for port in ports[:40]:
        with socket.socket() as sock:
            sock.bind(("0.0.0.0", port))


def test_a_held_port_is_skipped(fresh_chooser, monkeypatch):
    first = chip_smoke.free_port()
    monkeypatch.setattr(chip_smoke, "_port_rng",
                        random.Random(chip_smoke.PORT_SEED))
    monkeypatch.setattr(chip_smoke, "_ports_chosen", set())
    with socket.socket() as held:
        held.bind(("0.0.0.0", first))
        held.listen()
        again = chip_smoke.free_port()
    assert again != first


def test_the_range_is_read_from_proc():
    lo, hi = chip_smoke.local_port_range()
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        assert (lo, hi) == tuple(int(x) for x in f.read().split())
