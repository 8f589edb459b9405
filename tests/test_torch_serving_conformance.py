"""The serving-tier contract suite's slot cases, on the port's engines.

``tests/serving_conformance.py`` is imported unchanged.  Its contract
cube (per-tenant conservation, continuous-batching invariants, the
wrapped scheduler's training order) runs every (admission x scheduler)
pair through the suite's (reference) ``ServingOrchestrator`` under its
fixed tick on two port fleets, registered in the shared
``ENGINE_FACTORIES`` under the keys ``torch_slot`` (one paged engine)
and ``torch_group2_slot`` (a 2-replica ``EngineGroup`` of port
engines): the factories of ``tests/test_torch_policy_conformance.py``,
beside the suite's ``MATRIX_ENGINES``/``TAIL_ENGINES``.  The tail sweep
and the same-seed determinism case run the suite's own bodies on those
keys.
"""
import pytest

import policy_conformance as PC
import serving_conformance as SC
from serving_conformance import (  # noqa: F401  (collected here)
    admission_name, inner_name, test_continuous_batching_invariants,
    test_curriculum_composes, test_tenant_conservation)
from test_torch_policy_conformance import PORT_FACTORIES

ENGINE_NAMES = ("torch_slot", "torch_group2_slot")


@pytest.fixture(autouse=True)
def port_factories(monkeypatch):
    for name in ENGINE_NAMES:
        monkeypatch.setitem(PC.ENGINE_FACTORIES, name, PORT_FACTORIES[name])


@pytest.fixture(params=ENGINE_NAMES)
def engine_name(request):
    return request.param


def test_tail_machinery(admission_name, monkeypatch):
    monkeypatch.setattr(SC, "TAIL_ENGINES", ("torch_group2_slot",))
    SC.test_tail_machinery(admission_name)


def test_same_seed_identical_event_logs():
    SC.test_same_seed_identical_event_logs("torch_slot")
