"""The port's paged ``SlotEngine`` against the reference ``SlotEngine``.

Both engines serve the same prompts (numpy seed) with the same weights
(the reference's ``init_params``, carried over by ``repro_torch.convert``)
at temperature 0 on the Qwen3 smoke config in f32.  Greedy token streams
must be identical and logprobs within 1e-4 (f32; sums taken in another
order), and the page-pool counters equal, for the default path, fused
sampling, packed prefill, a GRPO group sharing a prompt,
oversubscription, interrupt -> resume without re-prefill, and a reference
``export_entry`` handle imported into the port.
"""
import ast
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as JQ
from repro.core.buffer import BufferEntry
from repro.models.model import build_model as jbuild
from repro.rollout.engine import SlotEngine as JEngine
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as TQ
from repro_torch.models.model import build_model
from repro_torch.rollout.engine import SlotEngine

LP_TOL = 1e-4
KW = dict(capacity=4, max_total_len=64, max_gen_len=6, eos_id=-1,
          temperature=0.0)
_M = {}


def _models():
    if not _M:
        jcfg = JQ.smoke_config().replace(param_dtype=jnp.float32,
                                         compute_dtype=jnp.float32)
        tcfg = TQ.smoke_config().replace(param_dtype=torch.float32,
                                         compute_dtype=torch.float32)
        jm = jbuild(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = build_model(tcfg, device="cpu")
        tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
        _M.update(jm=jm, jp=jp, tm=tm, tp=tp)
    return _M


def engines(**kw):
    m = _models()
    args = dict(KW, **kw)
    return (JEngine(m["jm"], lambda: m["jp"], **args),
            SlotEngine(m["tm"], lambda: m["tp"], **args))


def _prompts(n, seed=0, lo=2, hi=40):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 500, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def serve(eng, entries):
    """Continuous batching: refill free slots, step, until drained."""
    queue = list(entries)
    out = {e.uid: [] for e in entries}
    out.update({u: [] for u in eng.active_uids()})
    while queue or eng.active_uids():
        free = eng.free_slots()
        if free and queue:
            eng.submit(queue[:free], 0)
            queue = queue[free:]
        for ev in eng.step():
            out[ev.uid].append((ev.token, ev.logprob, ev.done,
                                ev.finish_reason))
    return out


def assert_same_streams(a, b):
    assert set(a) == set(b)
    for uid in a:
        assert [x[0] for x in a[uid]] == [x[0] for x in b[uid]], uid
        assert [x[2:] for x in a[uid]] == [x[2:] for x in b[uid]], uid
        np.testing.assert_allclose([x[1] for x in b[uid]],
                                   [x[1] for x in a[uid]], atol=LP_TOL,
                                   rtol=0)


@pytest.mark.parametrize("kw", [{}, {"fused_sampling": True},
                                {"packed_prefill": True}],
                         ids=["default", "fused", "packed"])
def test_oversubscribed_streams_match_reference(kw):
    """10 ragged requests through 4 slots (oversubscription) on each path."""
    es = [BufferEntry(uid=i, prompt=p) for i, p in enumerate(_prompts(10))]
    je, te = engines(**kw)
    assert_same_streams(serve(je, es), serve(te, es))
    assert te.cache_stats() == je.cache_stats()
    assert te.prefill_launches == je.prefill_launches


def test_grpo_group_shares_prompt_like_reference():
    prompt = _prompts(1, seed=1, lo=30, hi=31)[0]
    es = [BufferEntry(uid=i, prompt=list(prompt)) for i in range(4)]
    je, te = engines(fused_sampling=True)
    assert_same_streams(serve(je, es), serve(te, es))
    st = te.cache_stats()
    assert st == je.cache_stats()
    assert st["prefill_tokens_saved"] == 3 * (len(prompt) - 1)
    assert st["cow_copies"] >= 1 and st["pages_in_use"] == 0
    te.kv.check_invariants()


def test_interrupt_resume_without_reprefill_like_reference():
    prompts = _prompts(3, seed=2, lo=10, hi=30)
    out = []
    for eng in engines():
        es = [BufferEntry(uid=i, prompt=p) for i, p in enumerate(prompts)]
        eng.submit(es, 0)
        toks = {e.uid: [] for e in es}
        for _ in range(2):
            for ev in eng.step():
                toks[ev.uid].append((ev.token, ev.logprob))
        assert sorted(eng.interrupt()) == [0, 1, 2]
        run = eng.cache_stats()["prefill_tokens_run"]
        eng.submit([BufferEntry(uid=e.uid, prompt=e.prompt,
                                generated=[t for t, _ in toks[e.uid]])
                    for e in es], 1)
        st = eng.cache_stats()
        assert st["prefill_tokens_run"] == run, "resume re-ran prefill"
        assert st["resumed_without_prefill"] == 3
        while eng.active_uids():
            for ev in eng.step():
                toks[ev.uid].append((ev.token, ev.logprob))
        out.append((toks, st))
    (jt, jst), (tt, tst) = out
    assert jst == tst
    for uid in jt:
        assert [t for t, _ in jt[uid]] == [t for t, _ in tt[uid]]
        np.testing.assert_allclose([l for _, l in tt[uid]],
                                   [l for _, l in jt[uid]], atol=LP_TOL)


def test_reference_export_handle_continues_in_port():
    """A handle exported mid-decode by the reference engine lands in the
    port's engine, which continues with the reference's exact tokens."""
    prompts = _prompts(2, seed=3, lo=20, hi=40)
    je, te = engines()
    es = [BufferEntry(uid=i, prompt=p) for i, p in enumerate(prompts)]
    je.submit(es, 0)
    for _ in range(2):
        je.step()
    handle = je.export_entry(1)
    assert handle["active"] and handle["kv_quant"] is None
    assert te.import_entry(handle)
    je.discard_entry(1)
    # the reference continues uid 1 on its own engine too, for comparison
    jref, _ = engines()
    assert jref.import_entry(handle)
    want = serve(jref, [])
    got = serve(te, [])
    assert_same_streams(want, got)
    assert len(got[1]) == KW["max_gen_len"] - 2
    # and a port handle goes back into the reference engine
    te2 = engines()[1]
    te2.submit([BufferEntry(uid=7, prompt=prompts[0])], 0)
    te2.step()
    h2 = te2.export_entry(7)
    je2 = engines()[0]
    assert je2.import_entry(h2)
    te2.discard_entry(7)
    assert te2.export_entry(7) is None and te2.cache_stats()["pages_in_use"] == 0


def test_step_is_loop_free():
    """step() stays vectorized on the host: no per-slot Python loop."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(SlotEngine.step)))
    loops = [n for n in ast.walk(tree)
             if isinstance(n, (ast.For, ast.While, ast.AsyncFor))]
    assert not loops


def test_unported_options_raise():
    m = _models()
    base = dict(KW)
    for kw in ({"paged": False}, {"kv_quant": "int8"}):
        with pytest.raises(NotImplementedError):
            SlotEngine(m["tm"], lambda: m["tp"], **base, **kw)
    # a windowed config is served on the CPU (plain version applies the
    # window) and the engine never launches a kernel there
    windowed = build_model(m["tm"].cfg.replace(
        attn=m["tm"].cfg.attn.__class__(qk_norm=True, sliding_window=8,
                                        rope_theta=1e6)), device="cpu")
    eng = SlotEngine(windowed, lambda: m["tp"], **base)
    out = serve(eng, [BufferEntry(uid=0, prompt=_prompts(1, 4)[0])])
    assert len(out[0]) == KW["max_gen_len"]


def test_sampled_decode_is_seeded_and_finite():
    """temperature > 0 draws from a seeded torch.Generator: the same seed
    repeats the stream, logprobs are finite."""
    m = _models()
    es = [BufferEntry(uid=i, prompt=p) for i, p in enumerate(_prompts(3, 5))]
    runs = [serve(SlotEngine(m["tm"], lambda: m["tp"],
                             **dict(KW, temperature=1.0, seed=9)), es)
            for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(np.isfinite(x[1]) for v in runs[0].values() for x in v)
