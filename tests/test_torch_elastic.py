"""The port's elastic work leasing (``repro_torch.train.elastic``) against
the JAX package's, case by case.

Every case of ``tests/test_elastic.py`` and the elastic cases of
``tests/test_faults.py`` is written once as a scenario that returns what it
observed (leases, drain orders, steal and reassignment counts, dead hosts,
snapshots). Each scenario runs on both packages, the reference's own
assertions hold on each side, and the two records must be equal. Heartbeat
timeouts run on a ``FakeClock``, with no sleeps."""
import pytest

from conftest import FakeClock

import repro.train.elastic as jax_elastic
import repro_torch.train.elastic as port_elastic

SIDES = {"jax": jax_elastic, "torch": port_elastic}


def _both(scenario, *args):
    recs = {name: scenario(mod, *args) for name, mod in SIDES.items()}
    assert recs["torch"] == recs["jax"]
    return recs["torch"]


def sc_partition_cover_disjoint(m):
    ids = list(range(37))
    out = {}
    for hosts in (1, 2, 4, 8):
        leases = [m.partition_batches(ids, hosts, h) for h in range(hosts)]
        assert sorted(b for lease in leases for b in lease) == ids
        out[hosts] = leases
    return out


def sc_partition_deterministic_under_elastic_change(m):
    ids = list(range(64))
    a, b = m.partition_batches(ids, 8, 3), m.partition_batches(ids, 8, 3)
    assert a == b
    leases4 = [m.partition_batches(ids, 4, h) for h in range(4)]
    assert sorted(x for lease in leases4 for x in lease) == ids
    return a, leases4


def sc_work_stealing_drains_everything(m):
    q = m.WorkQueue(list(range(20)), num_hosts=4)
    seen = []
    while True:
        b = q.next_batch(0)                  # host 0 is fast, keeps asking
        if b is None:
            break
        seen.append(b)
    assert sorted(seen) == list(range(20))
    assert q.stolen > 0, "fast host must have stolen work"
    assert q.remaining() == 0
    return seen, q.stolen


def sc_heartbeats_detect_dead_host(m):
    clock = FakeClock()
    hb = m.Heartbeats(timeout_s=0.05, clock=clock)
    hb.beat(0)
    hb.beat(1)
    clock.advance(0.08)
    hb.beat(1)
    assert hb.dead_hosts() == [0]
    return hb.dead_hosts()


def sc_heartbeats_fake_clock(m):
    clock = FakeClock()
    hb = m.Heartbeats(timeout_s=1.0, clock=clock)
    hb.beat(0)
    hb.beat(1)
    clock.advance(2.0)
    hb.beat(1)
    assert hb.dead_hosts() == [0]
    clock.advance(0.5)
    return hb.dead_hosts()


def sc_dead_host_lease_reassigned_at_epoch_boundary(m):
    clock = FakeClock()
    coord = m.ElasticCoordinator(3, timeout_s=1.0, clock=clock)
    for h in range(3):
        coord.beat(h)
    clock.advance(2.0)
    coord.beat(0)
    coord.beat(1)                                 # host 2 went silent
    ids = list(range(10))
    q = coord.epoch_queue(ids)
    assert coord.dead == {2} and coord.live_hosts() == [0, 1]
    assert 2 not in q.leases                      # never a steal victim
    assert q.reassigned == len(m.partition_batches(ids, 3, 2))
    leases = {h: list(v) for h, v in q.leases.items()}
    drained = []
    while True:
        got = [b for h in (0, 1) if (b := q.next_batch(h)) is not None]
        if not got:
            break
        drained.extend(got)
    assert sorted(drained) == ids                 # full coverage, no loss
    q2 = coord.epoch_queue(ids)                   # death is sticky
    assert 2 not in q2.leases
    snap = coord.snapshot()
    coord.revive(2)
    assert coord.live_hosts() == [0, 1, 2]
    assert 2 in coord.epoch_queue(ids).leases
    return leases, drained, q.stolen, q.reassigned, snap, coord.snapshot()


def sc_reassign_with_all_hosts_dead_raises(m):
    q = m.WorkQueue(list(range(4)), 2)
    with pytest.raises(RuntimeError, match="all hosts dead") as e:
        q.reassign([0, 1])
    return str(e.value)


def sc_reassign_round_robins_onto_survivors(m):
    q = m.WorkQueue(list(range(23)), 5)
    moved = q.reassign([3, 1, 7])                # 7 is no host: ignored
    leases = {h: list(v) for h, v in sorted(q.leases.items())}
    order = [q.next_batch(h) for h in (4, 4, 0, 2, 4, 4, 4, 4, 4, 4)]
    return moved, q.reassigned, leases, order, q.stolen, q.remaining()


@pytest.mark.parametrize("scenario", [
    sc_partition_cover_disjoint,
    sc_partition_deterministic_under_elastic_change,
    sc_work_stealing_drains_everything,
    sc_heartbeats_detect_dead_host,
    sc_heartbeats_fake_clock,
    sc_dead_host_lease_reassigned_at_epoch_boundary,
    sc_reassign_with_all_hosts_dead_raises,
    sc_reassign_round_robins_onto_survivors,
], ids=lambda f: f.__name__[3:])
def test_port_equals_the_reference(scenario):
    _both(scenario)


def test_heartbeats_default_to_the_port_s_monotonic_clock():
    from repro_torch.serve.common import SystemClock
    hb = port_elastic.Heartbeats(timeout_s=60.0)
    assert hb._now.__self__.__class__ is SystemClock
    hb.beat(0)
    assert hb.dead_hosts() == []
