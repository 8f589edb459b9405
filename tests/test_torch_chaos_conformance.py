"""The chaos and autoscaler contract suites' slot cases, on port engines.

``tests/chaos_conformance.py`` is imported unchanged.  Its four
contract tests (conservation, group barrier, death recorded and fleet
drained, buffer invariants) run every registered policy through the
suite's (reference) orchestrator on two fleets of port ``SlotEngine``
replicas, registered in ``CHAOS_FACTORIES`` under keys of their own
(``torch_slot2``, ``torch_slot4``, so the suite's ``_DRIVE_CACHE`` keeps
them apart): a reference ``EngineGroup`` with ``migrate_kv=True`` and
the suite's ``kill_last`` plan, exactly as the suite builds its ``slot2``
and ``slot4`` fleets, with port engines as the leaves.

The slot cases that call the suite's module functions directly run the
suite's own body with that function bound to a port counterpart:

* ``test_slot_kill_rehomes_resident_kv_and_resumes_free``: ``_greedy_slot``;
* ``test_chaos_random_interleavings_hold_pool_invariants``: ``make_slot``;
* ``autoscaler_conformance.test_autoscaler_chaos_slot_fleet_holds_pool_
  invariants``: that suite's ``make_slot``.

All on ``device="cpu"`` with the engine suite's tiny model.
"""
import pytest

import torch_cpu  # noqa: F401
import autoscaler_conformance as AC
import chaos_conformance as CC
from chaos_conformance import (  # noqa: F401  (collected here)
    policy_name, test_chaos_buffer_invariants, test_chaos_conservation,
    test_chaos_death_recorded_and_fleet_drains, test_chaos_group_barrier)
from policy_conformance import CAPACITY
from repro.data import logic
from repro.rollout.group import EngineGroup
from repro_torch.rollout.engine import SlotEngine
from test_torch_engine_conformance import _tiny, make_slot

pytestmark = pytest.mark.chaos


def make_chaos_torch_slot(n_replicas):
    return EngineGroup(
        [make_slot(capacity=CAPACITY // n_replicas)
         for _ in range(n_replicas)],
        migrate_kv=True, fault_injector=CC.kill_last(n_replicas))


FLEETS = {"torch_slot2": 2, "torch_slot4": 4}


@pytest.fixture(autouse=True)
def port_factories(monkeypatch):
    for name, n in FLEETS.items():
        monkeypatch.setitem(CC.CHAOS_FACTORIES, name,
                            lambda n=n: make_chaos_torch_slot(n))
        monkeypatch.setitem(CC.N_REPLICAS, name, n)


@pytest.fixture(params=sorted(FLEETS))
def engine_name(request):
    return request.param


def _greedy_torch_slot(capacity):
    t = _tiny()
    return SlotEngine(t["model"], lambda: t["params"], capacity=capacity,
                      max_total_len=64, max_gen_len=8, eos_id=-1,
                      pad_id=logic.VOCAB.pad_id, temperature=0.0)


def test_slot_kill_rehomes_resident_kv_and_resumes_free(monkeypatch):
    monkeypatch.setattr(CC, "_greedy_slot", _greedy_torch_slot)
    CC.test_slot_kill_rehomes_resident_kv_and_resumes_free()


def test_chaos_random_interleavings_hold_pool_invariants(monkeypatch):
    monkeypatch.setattr(CC, "make_slot", make_slot)
    CC.test_chaos_random_interleavings_hold_pool_invariants()


def test_autoscaler_chaos_slot_fleet_holds_pool_invariants(monkeypatch):
    monkeypatch.setattr(AC, "make_slot", make_slot)
    AC.test_autoscaler_chaos_slot_fleet_holds_pool_invariants()
