"""Greedy streams of the MoE family's engines against the reference's
``SlotEngine``, on the CPU in f32, with ``test_torch_moe.py``'s models
(Granite-MoE-3B-A800M and Qwen3-MoE-235B-A22B at their smoke configs) and
tolerances: the paged, fused, packed, dense (``paged=False``) and int8
engines at the smoke capacity factor 2.0 and at a drop-heavy 0.5, with
more slots than requests so idle slots take capacity too: tokens equal,
logprobs within ``LP_TOL`` (1e-4), and every MoE call of both engines the
same count of (token, expert) pairs and of dropped pairs (in the
drop-heavy case the reference drops some, counted in the reference's own
calls).
"""
import jax
import numpy as np
import pytest

import torch_cpu  # noqa: F401
from repro.core.buffer import BufferEntry as JEntry
from repro.models import moe as JMOE
from repro.rollout.engine import SlotEngine as JEngine
from repro_torch.core.buffer import BufferEntry as TEntry
from repro_torch.models import moe as MOE
from repro_torch.rollout.engine import SlotEngine
from test_torch_moe import LP_TOL, _models

# -- engines -------------------------------------------------------------------

KW = dict(capacity=6, max_total_len=64, max_gen_len=6, eos_id=-1,
          temperature=0.0)


def _serve(eng, entries):
    """Continuous batching: refill free slots, step, until drained."""
    queue = list(entries)
    out = {e.uid: [] for e in entries}
    while queue or eng.active_uids():
        free = eng.free_slots()
        if free and queue:
            eng.submit(queue[:free], 0)
            queue = queue[free:]
        for ev in eng.step():
            out[ev.uid].append((ev.token, ev.logprob, ev.done,
                                ev.finish_reason))
    return out


def _counted(monkeypatch):
    """Record (pairs, dropped pairs) of every MoE call of both packages:
    the reference's from inside its jitted calls (a debug callback), the
    port's directly."""
    seen = {"ref": [], "port": []}
    jdisp, tdisp = JMOE._dispatch_indices, MOE._dispatch_indices

    def jwrap(idx, E, C):
        pos, keep = jdisp(idx, E, C)
        jax.debug.callback(lambda k: seen["ref"].append(
            (int(k.size), int(k.size - k.sum()))), keep)
        return pos, keep

    def twrap(idx, E, C):
        pos, keep = tdisp(idx, E, C)
        seen["port"].append((keep.numel(), int((~keep).sum())))
        return pos, keep
    monkeypatch.setattr(JMOE, "_dispatch_indices", jwrap)
    monkeypatch.setattr(MOE, "_dispatch_indices", twrap)
    return seen


ENGINES = {"paged": {}, "fused": {"fused_sampling": True},
           "packed": {"packed_prefill": True}, "dense": {"paged": False},
           "int8": {"kv_quant": "int8"}}
ENGINE_CASES = ([("granite_moe_3b_a800m", e) for e in ENGINES]
                + [("qwen3_moe_235b_a22b", "fused")])


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("arch,engine", ENGINE_CASES)
def test_greedy_streams_match_reference_engine(arch, engine, cf,
                                               monkeypatch):
    """8 requests through 6 slots, prompts of 2-30 ids: the second wave
    runs 2 requests beside 4 idle slots, each still feeding the last token
    its previous request made.  Tokens equal, logprobs within ``LP_TOL``,
    and each MoE call of the two engines the same (pairs, dropped) counts;
    at 0.5 the reference drops pairs."""
    jm, jp, tm, tp = _models(arch, cf)
    seen = _counted(monkeypatch)
    rng = np.random.RandomState(3)
    es = [(i, rng.randint(1, 500, size=rng.randint(2, 31)).tolist())
          for i in range(8)]
    args = dict(KW, **ENGINES[engine])
    je = JEngine(jm, lambda: jp, **args)
    te = SlotEngine(tm, lambda: tp, **args)
    a = _serve(je, [JEntry(uid=i, prompt=p) for i, p in es])
    b = _serve(te, [TEntry(uid=i, prompt=p) for i, p in es])
    assert set(a) == set(b)
    for uid in a:
        assert [x[0] for x in a[uid]] == [x[0] for x in b[uid]], uid
        assert [x[2:] for x in a[uid]] == [x[2:] for x in b[uid]], uid
        np.testing.assert_allclose([x[1] for x in b[uid]],
                                   [x[1] for x in a[uid]], atol=LP_TOL,
                                   rtol=0)
    assert len(seen["port"]) > 2 * KW["max_gen_len"]
    assert sorted(seen["ref"]) == sorted(seen["port"])
    dropped = sum(d for _, d in seen["ref"])
    assert (dropped > 0) == (cf < 1.0), dropped
