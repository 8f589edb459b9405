"""The Trainer-protocol contract suite, run on the port's SlotEngine.

Imports the scenario tests of ``tests/trainer_conformance.py`` unchanged
(conservation, delivery, staleness accounting, buffer invariants, and
the sync-mode identity of the bare callable and ``SyncTrainer``), every
registered trainer front x every policy, on the port's paged engine and
a 2-replica ``EngineGroup`` of port engines.  The factories are the ones
``tests/test_torch_policy_conformance.py`` registers in the shared
``ENGINE_FACTORIES`` under the keys ``torch_slot`` and
``torch_group2_slot`` (the trainer suite sweeps the reference's
``slot`` and ``group2_slot``), so the suite's ``_DRIVE_CACHE`` keeps
port runs apart.
"""
import pytest

import torch_cpu  # noqa: F401
import policy_conformance as PC
from test_torch_policy_conformance import PORT_FACTORIES
from trainer_conformance import (  # noqa: F401  (collected here)
    policy_name, test_all_updates_delivered,
    test_buffer_invariants_throughout, test_conservation,
    test_staleness_accounting, test_sync_mode_identity, trainer_kind)

ENGINE_NAMES = ("torch_slot", "torch_group2_slot")


@pytest.fixture(autouse=True)
def port_factories(monkeypatch):
    for name in ENGINE_NAMES:
        monkeypatch.setitem(PC.ENGINE_FACTORIES, name, PORT_FACTORIES[name])


@pytest.fixture(params=ENGINE_NAMES)
def engine_name(request):
    return request.param
