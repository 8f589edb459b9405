"""The left-padded recurrent families' engines and trainer on the port,
against the reference's, on the CPU in f32, with
``test_torch_recurrent.py``'s models (Zamba2-1.2B, with a tail layer for
the trainer, and xLSTM-125M at their smoke configs) and tolerances: the
dense engine's greedy streams and an interrupt/resume against the
reference's ``SlotEngine``, and one ``RLTrainer`` update.
"""
import jax
import numpy as np
import pytest

import torch_cpu  # noqa: F401
from repro.core.buffer import BufferEntry as JEntry
from repro.rl import trainer as JT
from repro.rollout.engine import SlotEngine as JEngine
from repro_torch import convert
from repro_torch.core.buffer import BufferEntry as TEntry
from repro_torch.rl import trainer as TT
from repro_torch.rollout.engine import SlotEngine
from repro_torch.train import optimizer as TO
from test_torch_families import (LP_TOL, PARAM_TOL, STEP_TOL, _entries,
                                 _reward, _same_streams, _serve)
from test_torch_recurrent import _models

# -- engines -----------------------------------------------------------------------

KW = dict(capacity=4, max_total_len=48, max_gen_len=6, eos_id=-1,
          temperature=0.0)


@pytest.mark.parametrize("name", ["zamba2", "xlstm"])
def test_greedy_streams_match_reference_engine(name):
    """10 requests of 2-20 ids through 4 slots on the dense layout
    (bucketed, left-padded widths): greedy tokens equal, logprobs within
    ``LP_TOL``, the same prefill launches and slot rows."""
    jm, jp, tm, tp = _models(name)
    rng = np.random.RandomState(3)
    es = [(i, rng.randint(1, 500, rng.randint(2, 21)).tolist())
          for i in range(10)]
    je = JEngine(jm, lambda: jp, **KW)
    te = SlotEngine(tm, lambda: tp, **KW)
    assert not te.paged and not je.paged
    _same_streams(_serve(je, [JEntry(uid=i, prompt=p) for i, p in es]),
                  _serve(te, [TEntry(uid=i, prompt=p) for i, p in es]))
    assert te.prefill_launches == je.prefill_launches


@pytest.mark.parametrize("name", ["zamba2", "xlstm"])
def test_interrupt_and_resume_match_reference_engine(name):
    """Three requests decode 3 steps, are interrupted, and resume with
    what they generated (a re-prefill at a new bucketed width): the
    streams equal the reference engine's, and a slot's ``kv_len`` and
    ``kv_start`` after each submit are the reference's."""
    jm, jp, tm, tp = _models(name)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, 500, n).tolist() for n in (5, 13, 9)]
    outs = []
    for Engine, Entry, m, p in ((JEngine, JEntry, jm, jp),
                                (SlotEngine, TEntry, tm, tp)):
        eng = Engine(m, lambda p=p: p, **KW)
        ents = [Entry(uid=i, prompt=list(pr)) for i, pr in enumerate(prompts)]
        eng.submit(ents, 0)
        rows = [(eng.slots.kv_len.tolist(), eng.slots.kv_start.tolist())]
        out = {i: [] for i in range(3)}
        for _ in range(3):
            for ev in eng.step():
                out[ev.uid].append((ev.token, ev.logprob))
        assert sorted(eng.interrupt()) == [0, 1, 2]
        for e in ents:
            e.generated = [t for t, _ in out[e.uid]]
        eng.submit(ents, 0)
        rows.append((eng.slots.kv_len.tolist(), eng.slots.kv_start.tolist()))
        for _ in range(3):
            for ev in eng.step():
                out[ev.uid].append((ev.token, ev.logprob))
        outs.append((out, rows))
    (jo, jr), (to, tr) = outs
    assert tr == jr
    for i in range(3):
        assert [t for t, _ in to[i]] == [t for t, _ in jo[i]]
        np.testing.assert_allclose([lp for _, lp in to[i]],
                                   [lp for _, lp in jo[i]], atol=LP_TOL,
                                   rtol=0)


# -- one trainer update ------------------------------------------------------------

@pytest.mark.parametrize("name", ["zamba2_tail", "xlstm"])
def test_rl_update_matches_reference_trainer(name):
    """One ``RLTrainer.update`` (GRPO, AdamW) on right-padded update
    batches through the SSD and the sLSTM loop under autograd: every
    metric within ``STEP_TOL``, every parameter leaf within
    ``PARAM_TOL``."""
    jm, jp, tm, _ = _models(name)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(pad_id=0, max_len=64, advantage_kind="grpo", opt_cfg=None)
    jt = JT.RLTrainer(jm, jp, _reward, **kw)
    tt = TT.RLTrainer(tm, tp, _reward, **kw)
    vocab = jm.cfg.vocab_size
    jrec = jt.update(_entries(JEntry, vocab), 0)
    trec = tt.update(_entries(TEntry, vocab), 0)
    assert set(jrec) == set(trec) and trec["grad_norm"] > 0
    for k in jrec:
        np.testing.assert_allclose(trec[k], jrec[k], err_msg=k, **STEP_TOL)
    for a, b in zip(jax.tree.leaves(jt.params()),
                    TO.tree_leaves(tt.params())):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   **PARAM_TOL)

