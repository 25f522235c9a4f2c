"""The port's LeaseFileElector against the reference's, on the CPU.

Each package's elector module gets the same fake clock (its `time`
attribute: the wall clock the lease file carries and the TTL is judged
by), and the same script runs through two electors of each package on a
lease of its own: acquire an absent lease, renew it, a second contender
held off while it is fresh, takeover after the TTL, the old holder
demoted, a corrupt and a far-future lease taken over, stop() releasing
only a lease it still holds. Every observation (leadership, holder,
lease file text, role callbacks in order) must be equal.
"""

import os

import pytest

from gie_tpu.runtime import leader as ref_leader
from gie_tpu_torch.runtime import leader as leader_mod


class _FakeTime:
    def __init__(self, t):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t


def _script(mod, lease):
    clock = _FakeTime(5000.0)
    calls = []
    a = mod.LeaseFileElector(lease, identity="a|10.0.0.1:9000",
                             lease_ttl_s=5.0)
    b = mod.LeaseFileElector(lease, identity="b|10.0.0.2:9000",
                             lease_ttl_s=5.0)
    a.on_role_change = lambda lead: calls.append(("a", lead))
    b.on_role_change = lambda lead: calls.append(("b", lead))
    obs = []

    def tick(*electors):
        for el in electors:
            el._set_leader(el._tick())
        text = open(lease).read() if os.path.exists(lease) else None
        obs.append((a.is_leader(), b.is_leader(), a.holder_identity(),
                    b.holder_identity(), text, list(calls)))

    real = mod.time
    mod.time = clock
    try:
        tick(a, b)                 # a creates the lease, b is held off
        clock.t += 2.0
        tick(b, a)                 # a renews
        clock.t += 4.0
        tick(b)                    # a's renewal is 4 s old: still held off
        clock.t += 2.0
        tick(b)                    # 6 s > TTL: b takes over
        tick(a)                    # a demoted
        with open(lease, "w") as f:
            f.write("garbage")
        tick(a, b)                 # corrupt lease: absent to its readers
        with open(lease, "w") as f:
            f.write(f"zz\n{clock.t + 3600.0}")
        tick(a, b)                 # far-future lease: corrupt, taken over
        holder = open(lease).read().split("\n")[0]
        loser = b if holder.startswith("a|") else a
        loser.stop()               # releases nothing it does not hold
        obs.append(("after loser stop", os.path.exists(lease)))
        (a if loser is b else b).stop()
        obs.append(("after holder stop", os.path.exists(lease), list(calls)))
    finally:
        mod.time = real
    return obs


def test_lease_file_elector_equals_the_reference(tmp_path):
    port = _script(leader_mod, str(tmp_path / "port.lease"))
    ref = _script(ref_leader, str(tmp_path / "ref.lease"))
    assert port == ref
    first = port[0]
    assert first[0] and not first[1]
    assert first[2] == first[3] == "a|10.0.0.1:9000"
    assert port[0][5] == [("a", True)]
    takeover = port[3]
    assert takeover[1] and takeover[3] == "b|10.0.0.2:9000"
    assert port[4][5] == [("a", True), ("b", True), ("a", False)]
    assert port[-2] == ("after loser stop", True)
    assert port[-1][1] is False


@pytest.mark.parametrize("mod", [leader_mod, ref_leader],
                         ids=["port", "reference"])
def test_role_callback_errors_never_stop_the_election(mod, tmp_path):
    el = mod.LeaseFileElector(str(tmp_path / "lease"), identity="x")

    def boom(_lead):
        raise RuntimeError("callback bug")

    el.on_role_change = boom
    el._set_leader(el._tick())
    assert el.is_leader() and el.holder_identity() == "x"
    el.stop()
    assert not el.is_leader()
    assert not os.path.exists(str(tmp_path / "lease"))
