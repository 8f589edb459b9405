"""The SchedulerPolicy contract suite, run on the port's SlotEngine.

Imports the scenario tests of ``tests/policy_conformance.py`` unchanged
and runs every registered policy through the suite's (reference)
``RolloutOrchestrator`` on the port's engines, registered in the suite's
``ENGINE_FACTORIES`` under keys of their own, so the suite's memoised
``_DRIVE_CACHE`` keeps port runs apart from reference runs:

* ``torch_slot``: the paged engine, sampled decode with a real EOS id
  (the suite's ``make_slot_varied``);
* ``torch_slot_roofline``: packed prefill + fused sampling + int8 pages
  (``make_slot_roofline``);
* ``torch_group2_slot``: a 2-replica ``EngineGroup`` of port engines
  (``make_group_slot_varied``).

All on ``device="cpu"`` with the engine suite's tiny model (see
``tests/test_torch_engine_conformance.py``).  The ``sim`` and group-of-sim
keys are the reference's own and stay in ``policy_conformance.py``.
"""
import pytest

import policy_conformance as PC
from policy_conformance import (  # noqa: F401  (collected here)
    policy_name, test_buffer_invariants_throughout, test_conservation,
    test_curriculum_ordering, test_group_barrier, test_no_starvation)
from repro.data import logic
from repro.rollout.group import EngineGroup
from test_torch_engine_conformance import make_slot


def make_torch_slot():
    return make_slot(eos_id=logic.VOCAB.eos_id)


def make_torch_slot_roofline():
    return make_slot(eos_id=logic.VOCAB.eos_id, packed_prefill=True,
                     fused_sampling=True, kv_quant="int8")


def make_torch_group2_slot():
    return EngineGroup([make_slot(capacity=PC.CAPACITY // 2,
                                  eos_id=logic.VOCAB.eos_id)
                        for _ in range(2)])


PORT_FACTORIES = {"torch_slot": make_torch_slot,
                  "torch_slot_roofline": make_torch_slot_roofline,
                  "torch_group2_slot": make_torch_group2_slot}


@pytest.fixture(autouse=True)
def port_factories(monkeypatch):
    for name, factory in PORT_FACTORIES.items():
        monkeypatch.setitem(PC.ENGINE_FACTORIES, name, factory)


@pytest.fixture(params=sorted(PORT_FACTORIES))
def engine_name(request):
    return request.param
