"""The EngineProtocol contract suite, run against the port's SlotEngine.

Imports the scenario tests of ``tests/engine_conformance.py`` unchanged
and overrides its ``engine_factory`` fixture with port factories: the
paged engine (``slot``), with packed prefill (``slot_packed``), with
fused greedy sampling (``slot_fused``), the dense layout
(``slot_dense``) and int8 KV pages (``slot_int8``), all on
``device="cpu"`` with the suite's tiny model (``tiny_lm_config``,
d_model 32, 1 layer, 2 heads); and the gemma2 smoke config (local/global
layers, a 16-row ring, softcaps) on its dense layout (``slot_gemma2``);
and the xLSTM smoke config in f32 (``slot_left``: the left-padded dense
layout, ``kv_start`` and the generation-headroom bucket), which also
takes the place of the suite's own ``make_slot_left`` for
``test_left_padding_bucketing_keeps_gen_headroom``, imported unchanged.

Left out, with the reason:

* ``test_slot_engine_step_is_loop_free``,
  ``test_prefill_cache_bounded_by_bucketing``,
  ``test_prefill_and_decode_caches_keyed_by_kv_dtype`` and
  ``test_slot_table_shared_by_both_engines``: they are written against
  the reference ``SlotEngine`` class itself (its source, its compile
  caches, its SlotTable); the port keeps no compile cache, and its own
  loop-free check is in ``tests/test_torch_engine.py``.
* The paged, packed, fused, int8 and group cases after the scenarios
  call the suite's own ``make_slot`` directly, so they build the
  reference engine whatever fixture is in force; ``test_torch_engine.py``
  holds their port counterparts against the reference.
"""
import torch_cpu  # noqa: F401
import engine_conformance
import pytest
import torch

from engine_conformance import (  # noqa: F401  (collected here)
    CAPACITY, MAX_GEN, MAX_TOTAL, test_event_order_stable_while_resident,
    test_interrupt_idempotent, test_interrupt_selective,
    test_left_padding_bucketing_keeps_gen_headroom,
    test_oversubscription_refill, test_protocol_surface,
    test_scavenge_resume_cycle, test_step_events_and_budget,
    test_step_on_empty_engine, test_submit_accounting)
from repro.data import logic
from repro_torch.configs.base import get_smoke_config, tiny_lm_config
from repro_torch.models.model import build_model
from repro_torch.rollout.engine import SlotEngine

_TINY = {}
_GEMMA2 = {}
_LEFT = {}


def _tiny():
    if not _TINY:
        cfg = tiny_lm_config(len(logic.VOCAB), d_model=32, layers=1, heads=2)
        model = build_model(cfg, device="cpu")
        _TINY["model"] = model
        _TINY["params"] = model.init_params(torch.Generator().manual_seed(0))
    return _TINY


def make_slot(capacity=CAPACITY, max_gen=MAX_GEN, eos_id=-1, **kw):
    t = _tiny()
    # eos_id=-1: finishes are budget-driven, so scenarios are deterministic
    return SlotEngine(t["model"], lambda: t["params"], capacity=capacity,
                      max_total_len=MAX_TOTAL, max_gen_len=max_gen,
                      eos_id=eos_id, pad_id=logic.VOCAB.pad_id,
                      temperature=1.0, **kw)


def make_slot_gemma2(capacity=CAPACITY, max_gen=MAX_GEN, eos_id=-1):
    if not _GEMMA2:
        cfg = get_smoke_config("gemma2_2b").replace(
            param_dtype=torch.float32, compute_dtype=torch.float32)
        model = build_model(cfg, device="cpu")
        _GEMMA2["model"] = model
        _GEMMA2["params"] = model.init_params(torch.Generator().manual_seed(0))
    return SlotEngine(_GEMMA2["model"], lambda: _GEMMA2["params"],
                      capacity=capacity, max_total_len=MAX_TOTAL,
                      max_gen_len=max_gen, eos_id=eos_id,
                      pad_id=logic.VOCAB.pad_id, temperature=1.0)


def make_slot_left(capacity=CAPACITY, max_gen=MAX_GEN, eos_id=-1,
                   max_total=MAX_TOTAL):
    """The xLSTM smoke config in f32: a left-padding model on the dense
    layout."""
    if not _LEFT:
        cfg = get_smoke_config("xlstm_125m").replace(
            param_dtype=torch.float32, compute_dtype=torch.float32)
        model = build_model(cfg, device="cpu")
        assert model.padding_side == "left"
        _LEFT["model"] = model
        _LEFT["params"] = model.init_params(torch.Generator().manual_seed(1))
    return SlotEngine(_LEFT["model"], lambda: _LEFT["params"],
                      capacity=capacity, max_total_len=max_total,
                      max_gen_len=max_gen, eos_id=eos_id, pad_id=0,
                      temperature=1.0)


def make_slot_packed(capacity=CAPACITY, max_gen=MAX_GEN, eos_id=-1):
    return make_slot(capacity, max_gen, eos_id, packed_prefill=True)


def make_slot_fused(capacity=CAPACITY, max_gen=MAX_GEN, eos_id=-1):
    return make_slot(capacity, max_gen, eos_id, fused_sampling=True)


def make_slot_dense(capacity=CAPACITY, max_gen=MAX_GEN, eos_id=-1):
    return make_slot(capacity, max_gen, eos_id, paged=False)


def make_slot_int8(capacity=CAPACITY, max_gen=MAX_GEN, eos_id=-1):
    return make_slot(capacity, max_gen, eos_id, kv_quant="int8")


ENGINES = [("slot", make_slot), ("slot_packed", make_slot_packed),
           ("slot_fused", make_slot_fused), ("slot_dense", make_slot_dense),
           ("slot_int8", make_slot_int8), ("slot_gemma2", make_slot_gemma2),
           ("slot_left", make_slot_left)]


@pytest.fixture(params=[name for name, _ in ENGINES])
def engine_factory(request):
    return dict(ENGINES)[request.param]


@pytest.fixture(autouse=True)
def _port_left_engine(monkeypatch):
    """The suite's scenarios that build their left-padding engine through
    its module-level ``make_slot_left`` get the port's."""
    monkeypatch.setattr(engine_conformance, "make_slot_left", make_slot_left)
