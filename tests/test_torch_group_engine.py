"""The group and migration cases of the engine suite, on port engines.

``tests/engine_conformance.py`` is imported unchanged.  These cases call
the suite's module functions (``make_group_sim``, ``make_group_slot``,
``make_slot``, ``make_slot_int8``) directly rather than through a
fixture, so each runs the suite's own body with those names bound to
port counterparts, on two fleets:

* ``ref_group``: the reference ``EngineGroup`` over port ``SlotEngine``
  replicas (the suite's ``make_group_slot`` with port leaves);
* ``port_group``: the port's own ``EngineGroup`` copy over the same.

``test_group_conservation_across_replicas`` builds its fleet with
``make_group_sim``; here that name yields the slot fleets above (and, in
``test_group_conservation_across_port_sim_replicas``, the port's
``EngineGroup`` over the port's ``SimEngine``).
The suite's fixture-driven scenarios (protocol surface, accounting,
events, interrupt, scavenge/resume, oversubscription) also run here on
the port's ``EngineGroup`` as the suite builds its ``group_sim``,
``group_slot`` and ``group_mig`` fleets: over port ``SimEngine`` or
``SlotEngine`` replicas, the last with ``migrate_kv=True``.

All on ``device="cpu"`` with the suite's tiny model.
"""
import pytest

import torch_cpu  # noqa: F401
import engine_conformance as EC
from engine_conformance import (  # noqa: F401  (collected here)
    test_event_order_stable_while_resident, test_interrupt_idempotent,
    test_interrupt_selective, test_oversubscription_refill,
    test_protocol_surface, test_scavenge_resume_cycle,
    test_step_events_and_budget, test_step_on_empty_engine,
    test_submit_accounting)
from repro.rollout.group import EngineGroup as RefGroup
from repro_torch.rollout.group import EngineGroup as PortGroup
from repro_torch.rollout.sim import SimEngine as PortSim
from test_torch_engine_conformance import make_slot, make_slot_int8


def _fleet(group_cls):
    def make(capacity=EC.CAPACITY, max_gen=EC.MAX_GEN, eos_id=-1,
             n_replicas=2, **kw):
        assert capacity % n_replicas == 0
        return group_cls([make_slot(capacity=capacity // n_replicas,
                                    max_gen=max_gen, eos_id=eos_id, **kw)
                          for _ in range(n_replicas)])
    return make


def _port_sim_fleet(capacity=EC.CAPACITY, max_gen=EC.MAX_GEN, n_replicas=2):
    return PortGroup([PortSim(capacity=capacity // n_replicas,
                              max_gen_len=max_gen, seed=i)
                      for i in range(n_replicas)])


FLEETS = {"ref_group": _fleet(RefGroup), "port_group": _fleet(PortGroup)}


def _port_mig_fleet(capacity=EC.CAPACITY, max_gen=EC.MAX_GEN, eos_id=-1,
                    n_replicas=2):
    return PortGroup([make_slot(capacity=capacity // n_replicas,
                                max_gen=max_gen, eos_id=eos_id)
                      for _ in range(n_replicas)], migrate_kv=True)


PORT_GROUPS = {"port_group_sim": _port_sim_fleet,
               "port_group_slot": _fleet(PortGroup),
               "port_group_mig": _port_mig_fleet}


@pytest.fixture(params=sorted(PORT_GROUPS))
def engine_factory(request):
    return PORT_GROUPS[request.param]


@pytest.fixture(params=sorted(FLEETS))
def port_fleet(request, monkeypatch):
    monkeypatch.setattr(EC, "make_group_slot", FLEETS[request.param])
    monkeypatch.setattr(EC, "make_group_sim", FLEETS[request.param])
    monkeypatch.setattr(EC, "make_slot", make_slot)
    return request.param


def test_group_conservation_across_replicas(port_fleet):
    EC.test_group_conservation_across_replicas()


def test_group_conservation_across_port_sim_replicas(monkeypatch):
    monkeypatch.setattr(EC, "make_group_sim", _port_sim_fleet)
    EC.test_group_conservation_across_replicas()


def test_group_home_affinity_resume_zero_reprefill(port_fleet):
    EC.test_group_home_affinity_resume_zero_reprefill()


def test_group_steal_migrates_when_home_is_full(port_fleet):
    EC.test_group_steal_migrates_when_home_is_full()


def test_group_event_merge_order_is_replica_major(port_fleet):
    EC.test_group_event_merge_order_is_replica_major()


def test_int8_scale_planes_follow_cow_and_migration(monkeypatch):
    monkeypatch.setattr(EC, "make_slot", make_slot)
    monkeypatch.setattr(EC, "make_slot_int8", make_slot_int8)
    EC.test_int8_scale_planes_follow_cow_and_migration()
