"""The port's ``SlotEngine`` against the reference ``SlotEngine``.

Both engines serve the same prompts (numpy seed) with the same weights
(the reference's ``init_params``, carried over by ``repro_torch.convert``)
at temperature 0 on the Qwen3 smoke config in f32.  Greedy token streams
must be identical and logprobs within 1e-4 (f32; sums taken in another
order), and the page-pool counters equal, for the default path, fused
sampling, packed prefill, the dense layout (``paged=False``), a GRPO
group sharing a prompt, oversubscription, interrupt -> resume without
re-prefill, and a reference ``export_entry`` handle imported into the
port.  int8 pages (``kv_quant="int8"``): the quantiser exactly, pool
bytes after prefill exactly, greedy decode streams identical with
logprobs within the f32 bound stated at ``INT8_LP_TOL``.
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
from repro_torch.train.optimizer import tree_map

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
        tp = convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                     device="cpu")
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


# -- the dense layout (paged=False) -------------------------------------------

def test_dense_oversubscribed_streams_match_reference():
    """10 ragged requests through 4 dense slots, against the reference's
    dense engine: streams identical, logprobs within 1e-4."""
    es = [BufferEntry(uid=i, prompt=p) for i, p in enumerate(_prompts(10))]
    je, te = engines(paged=False)
    assert not te.paged and te.kv is None
    assert_same_streams(serve(je, es), serve(te, es))
    assert te.cache_stats() is None and je.cache_stats() is None
    assert te.prefill_launches == je.prefill_launches


def test_dense_and_paged_port_streams_identical():
    """The ROADMAP gate of the dense layout: the port's dense and paged
    engines give the same greedy streams, a GRPO group included (the
    paged engine shares its prompt and copies on write)."""
    prompts = _prompts(6, seed=7) + [_prompts(1, seed=8, lo=20, hi=21)[0]] * 3
    es = [BufferEntry(uid=i, prompt=list(p)) for i, p in enumerate(prompts)]
    m = _models()
    out = [serve(SlotEngine(m["tm"], lambda: m["tp"], paged=paged, **KW), es)
           for paged in (False, True)]
    assert_same_streams(*out)


def test_dense_engine_migrates_nothing_and_keeps_no_pool():
    m = _models()
    te = SlotEngine(m["tm"], lambda: m["tp"], paged=False, **KW)
    es = [BufferEntry(uid=i, prompt=p) for i, p in enumerate(_prompts(3))]
    te.submit(es, 0)
    te.step()
    assert te.export_entry(0) is None
    je = engines()[0]
    je.submit(es[:1], 0)
    je.step()
    assert not te.import_entry(je.export_entry(0))
    te.sync_weights(2)
    assert sorted(te.interrupt(uids=[1])) == [1]
    te.discard_entry(2)
    assert te.active_uids() == [0] and te.version == 2
    te.shutdown()
    assert te.free_slots() == KW["capacity"]


def test_options_that_need_pages_refuse_the_dense_layout():
    m = _models()
    for kw in ({"kv_quant": "int8"}, {"packed_prefill": True},
               {"fused_sampling": True}):
        with pytest.raises(ValueError, match="paged layout"):
            SlotEngine(m["tm"], lambda: m["tp"], paged=False, **KW, **kw)
    with pytest.raises(ValueError, match="kv_quant"):
        SlotEngine(m["tm"], lambda: m["tp"], kv_quant="fp8", **KW)


# -- int8 KV pages ------------------------------------------------------------

def test_int8_scatter_quantises_like_reference_exactly():
    """Both engines' ``_scatter_pages`` on one f32 sub-cache: int8 pool
    and scale planes bit for bit (amax / 127 with a 1e-8 floor, round half
    to even), an all-zero page and x.5 cells included."""
    je, te = engines(kv_quant="int8")
    cfg = te.model.cfg
    rng = np.random.RandomState(13)
    shape = (cfg.num_layers, 3, 48, cfg.num_kv_heads, cfg.resolved_head_dim)
    sub = {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
    sub["k"][:, 1, 16:32] = 0.0                 # an all-zero page
    sub["v"][:, 0, :16] = np.round(sub["v"][:, 0, :16] * 2) / 2
    rows, blks, phys = [0, 0, 1, 2, 2], [0, 2, 1, 0, 1], [3, 9, 4, 7, 1]
    je._scatter_pages({n: jnp.asarray(a) for n, a in sub.items()},
                      np.asarray(rows), np.asarray(blks), np.asarray(phys))
    te._scatter_pages({n: torch.from_numpy(a) for n, a in sub.items()},
                      rows, blks, phys)
    for n in ("k", "v"):
        np.testing.assert_array_equal(te.cache[n].numpy(),
                                      np.asarray(je.cache[n]))
        np.testing.assert_array_equal(te.kv_scales[n].numpy(),
                                      np.asarray(je.kv_scales[n]))
    assert float(te.kv_scales["k"][0, 4]) == np.float32(1e-8) / 127


@pytest.mark.parametrize("kw", [{}, {"packed_prefill": True}],
                         ids=["bucketed", "packed"])
def test_int8_pool_after_prefill_matches_reference(kw):
    """A prefill wave (a GRPO group sharing its prompt included): the
    whole int8 pool equals the reference engine's byte for byte; scales
    to f32 rounding (rtol 1e-6), since a page's scale is its amax / 127
    and the two frameworks compute the prefilled K/V with another sum
    order (the quantiser itself is exact, test above)."""
    prompts = _prompts(3, seed=9) + [_prompts(1, seed=10, lo=30, hi=31)[0]]
    es = [BufferEntry(uid=i, prompt=list(p)) for i, p in enumerate(prompts)]
    je, te = engines(kv_quant="int8", **kw)
    assert te.cache["k"].dtype == torch.int8
    for eng in (je, te):
        eng.submit(es, 0)
    for n in ("k", "v"):
        np.testing.assert_array_equal(te.cache[n].numpy(),
                                      np.asarray(je.cache[n]))
        np.testing.assert_allclose(te.kv_scales[n].numpy(),
                                   np.asarray(je.kv_scales[n]), rtol=1e-6,
                                   atol=0)
    assert te.cache_stats() == je.cache_stats()
    assert te.kv_scales["k"][:, 1:].ne(1.0).any()      # scales were written


# f32 logprobs of the int8 engines.  Both attend in the same order (old
# rows at their page's scale, the new row unquantised, then requantise),
# so they differ only by f32 sum order, except where that order tips a
# cell sitting at an int8 rounding tie to the next step (7 of the pool's
# cells in this run, all one step); such a cell moves later logprobs by
# a few 1e-4 nats (at most 4.2e-4 here, every other step below 5e-6).
INT8_LP_TOL = 1e-3
INT8_TIE_CELLS = 16


def test_int8_streams_within_bounds_of_reference():
    """Oversubscribed ragged requests on both int8 engines: the port's
    greedy streams equal the reference's on all 8 requests, logprobs
    within ``INT8_LP_TOL``, pool counters equal, and the int8 pools equal
    but for at most ``INT8_TIE_CELLS`` cells one int8 step apart (rounding
    ties, see above)."""
    es = [BufferEntry(uid=i, prompt=p) for i, p in enumerate(_prompts(8))]
    je, te = engines(kv_quant="int8")
    want, got = serve(je, es), serve(te, es)
    assert set(want) == set(got)
    for e in es:
        assert [x[0] for x in got[e.uid]] == [x[0] for x in want[e.uid]], \
            e.uid
        assert [x[2:] for x in got[e.uid]] == [x[2:] for x in want[e.uid]]
        np.testing.assert_allclose([x[1] for x in got[e.uid]],
                                   [x[1] for x in want[e.uid]],
                                   atol=INT8_LP_TOL, rtol=0)
    assert te.cache_stats() == je.cache_stats()
    for n in ("k", "v"):
        step = np.abs(te.cache[n].numpy().astype(np.int32)
                      - np.asarray(je.cache[n]).astype(np.int32))
        assert step.max() <= 1 and (step > 0).sum() <= INT8_TIE_CELLS, n


def test_int8_kv_decode_stays_close_to_fp():
    """Counterpart of the reference's test of the same name: the int8
    engine completes every request, and its first greedy token (decoded
    off freshly quantised prefill pages) equals the fp engine's."""
    m = _models()
    es = [BufferEntry(uid=i, prompt=p) for i, p in enumerate(_prompts(6, 11))]
    fp = serve(SlotEngine(m["tm"], lambda: m["tp"], **KW), es)
    q8 = SlotEngine(m["tm"], lambda: m["tp"], kv_quant="int8", **KW)
    got = serve(q8, es)
    assert set(got) == set(fp)
    assert all(got[u][0][0] == fp[u][0][0] for u in fp)
    assert all(len(v) == KW["max_gen_len"] for v in got.values())
    assert q8.cache_stats()["pages_in_use"] == 0
    q8.kv.check_invariants()


def test_int8_scale_planes_follow_cow_and_migration():
    """Scales travel with their pages: copy-on-write copies the scale,
    an int8 handle goes from the reference to the port and back and
    continues token-identically, and fp and int8 pools refuse each
    other's handles."""
    prompt = _prompts(1, seed=12, lo=10, hi=11)[0]
    m = _models()
    src = SlotEngine(m["tm"], lambda: m["tp"], kv_quant="int8",
                     **dict(KW, capacity=2))
    src.submit([BufferEntry(uid=i, prompt=list(prompt)) for i in range(2)], 0)
    copies = src.kv.prepare_step([0, 1], [len(prompt) - 1] * 2)
    assert copies
    src._copy_pages(copies)
    for s_, d_ in copies:
        for n in ("k", "v"):
            assert torch.equal(src.kv_scales[n][:, d_], src.kv_scales[n][:, s_])
            assert torch.equal(src.cache[n][:, d_], src.cache[n][:, s_])

    # reference -> port: continues with the reference's tokens
    es = [BufferEntry(uid=i, prompt=p)
          for i, p in enumerate(_prompts(2, seed=3, lo=20, hi=40))]
    je, te = engines(kv_quant="int8")
    je.submit(es, 0)
    for _ in range(2):
        je.step()
    handle = je.export_entry(1)
    assert handle["kv_quant"] == "int8" and handle["pages_k"].dtype == np.int8
    assert te.import_entry(handle)
    pages = list(te.kv.tables[1])
    np.testing.assert_array_equal(te.kv_scales["k"][:, pages].numpy(),
                                  handle["scales_k"])
    np.testing.assert_array_equal(te.cache["v"][:, pages].numpy(),
                                  handle["pages_v"])
    jref = engines(kv_quant="int8")[0]
    assert jref.import_entry(handle)
    want, got = serve(jref, []), serve(te, [])
    assert [x[0] for x in got[1]] == [x[0] for x in want[1]]
    np.testing.assert_allclose([x[1] for x in got[1]],
                               [x[1] for x in want[1]], atol=0.05)

    # port -> reference, and the pools that must refuse
    te2 = engines(kv_quant="int8")[1]
    te2.submit([BufferEntry(uid=7, prompt=es[0].prompt)], 0)
    te2.step()
    h2 = te2.export_entry(7)
    assert h2["kv_quant"] == "int8"
    np.testing.assert_array_equal(
        h2["scales_v"], te2.kv_scales["v"][:, h2["kv"].pages].numpy())
    fp_j, fp_t = engines()
    assert not fp_t.import_entry(h2) and not fp_j.import_entry(h2)
    fp_j.submit([BufferEntry(uid=8, prompt=es[0].prompt)], 0)
    assert not te2.import_entry(fp_j.export_entry(8))
    je2 = engines(kv_quant="int8")[0]
    assert je2.import_entry(h2)
    te2.discard_entry(7)
    assert te2.cache_stats()["pages_in_use"] == 0
    assert len(serve(je2, [])[7]) == KW["max_gen_len"] - 1


@pytest.mark.parametrize("kw", [{}, {"fused_sampling": True},
                                {"packed_prefill": True}, {"paged": False},
                                {"kv_quant": "int8"}],
                         ids=["default", "fused", "packed", "dense", "int8"])
def test_params_that_require_grad_leave_no_graph_in_the_engine(kw):
    """A trainer's parameters may require grad; the engine's entry points
    run under ``torch.no_grad()``, so its caches, scales and handles carry
    no ``grad_fn`` and its events plain numbers, and the tokens are those
    of the same weights without grad."""
    m = _models()
    grad_params = tree_map(lambda p: p.detach().clone().requires_grad_(),
                           m["tp"])
    es = [BufferEntry(uid=i, prompt=p) for i, p in enumerate(_prompts(5))]
    eng = SlotEngine(m["tm"], lambda: grad_params, **dict(KW, **kw))
    got = serve(eng, es)
    want = serve(SlotEngine(m["tm"], lambda: m["tp"], **dict(KW, **kw)), es)
    assert {u: [x[0] for x in v] for u, v in got.items()} == \
        {u: [x[0] for x in v] for u, v in want.items()}
    for t in (*eng.cache.values(), *eng.kv_scales.values()):
        assert t.grad_fn is None and not t.requires_grad
    if eng.paged:
        eng.submit([BufferEntry(uid=99, prompt=_prompts(1, seed=9)[0])], 0)
        eng.step()
        handle = eng.export_entry(99)
        assert isinstance(handle["pages_k"], np.ndarray)
        eng.discard_entry(99)
        assert eng.import_entry(handle)
        for t in eng.cache.values():
            assert t.grad_fn is None
