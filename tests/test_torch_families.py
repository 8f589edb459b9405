"""The rest of the dense family on the port, against the reference, on the
CPU in f32: Gemma2-2B (local/global layers, ring caches, softcaps),
Qwen1.5-110B (qkv bias) and Nemotron-4-340B (squared ReLU, no gate), each
at its ``smoke_config()``.

Weights come from the reference's ``init_params`` and are carried over
with ``repro_torch.convert``; inputs are numpy arrays from a seed fed to
both packages.  Tolerances are ``tests/test_torch_model.py``'s: atol =
rtol = 1e-4 (f32; only the order of sums differs between the
frameworks); engine logprobs ``LP_TOL`` (1e-4) of
``tests/test_torch_engine.py``; the trainer's ``STEP_TOL``/``PARAM_TOL``
of ``tests/test_torch_rl.py``.

Where the reference is wrong the port is held to its own forward instead:
the reference fills a gemma2 ring at prefill from the last W columns of
the padded width, so a prompt shorter than a prefill wider than the
window gets pad rows in its ring.  The port fills each row's ring from
its own length and equals its plain forward there within 1e-5.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from repro.configs.base import ARCH_ALIASES as JALIASES
from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke
from repro.core.buffer import BufferEntry as JEntry
from repro.models.model import build_model as jbuild
from repro.rl import trainer as JT
from repro.rollout.engine import SlotEngine as JEngine
from repro_torch import convert
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.buffer import BufferEntry as TEntry
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model, supports_paging
from repro_torch.rl import trainer as TT
from repro_torch.rollout.engine import SlotEngine
from repro_torch.train import optimizer as TO

ATOL = dict(atol=1e-4, rtol=1e-4)
LP_TOL = 1e-4
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=0.1 * 3e-4)     # 0.1 lr (AdamWConfig())
OWN_FORWARD_TOL = 1e-5
ARCHS = ["gemma2_2b", "qwen1_5_110b", "nemotron_4_340b"]
# the MoE family: config parity and the init tree here, the rest in
# tests/test_torch_moe.py
MOE_ARCHS = ["granite_moe_3b_a800m", "qwen3_moe_235b_a22b"]
_CACHE = {}


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _models(arch):
    if arch not in _CACHE:
        jcfg = jget_smoke(arch).replace(param_dtype=jnp.float32,
                                        compute_dtype=jnp.float32)
        tcfg = get_smoke_config(arch).replace(param_dtype=torch.float32,
                                              compute_dtype=torch.float32)
        jm = jbuild(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(1))
        tm = build_model(tcfg, device="cpu")
        tp = convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _CACHE[arch] = (jm, jp, tm, tp)
    return _CACHE[arch]


def _close_tree(want, got):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **ATOL)


# -- configs and init ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_configs_match_reference_apart_from_dtype(arch):
    for j, t in ((jget_config(arch), get_config(arch)),
                 (jget_smoke(arch), get_smoke_config(arch))):
        for f in dataclasses.fields(j):
            if f.name not in ("param_dtype", "compute_dtype", "attn", "moe"):
                assert getattr(j, f.name) == getattr(t, f.name), f.name
        assert dataclasses.asdict(j.attn) == dataclasses.asdict(t.attn)
        assert (j.moe is None) == (t.moe is None)
        if j.moe is not None:
            assert dataclasses.asdict(j.moe) == dataclasses.asdict(t.moe)
        assert t.param_dtype == t.compute_dtype == torch.bfloat16
    aliases = [a for a, m in JALIASES.items() if m == arch]
    assert aliases and all(get_config(a) == get_config(arch) for a in aliases)


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_init_tree_matches_reference_key_for_key(arch):
    jm, jp, tm, _ = _models(arch)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    jn = jax.tree.map(np.asarray, jp)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert tuple(a[k].shape) == tuple(b[k].shape), path + k
                sa, sb = float(np.std(a[k])), float(b[k].float().std())
                assert abs(sa - sb) <= 0.1 * max(sa, 1e-6), (path + k, sa, sb)
    walk(jn, tp)
    lead = tp["layers"]["ln1"]["scale"].shape[:-1]
    L = jm.cfg.num_layers
    assert lead == ((L // 2, 2) if arch == "gemma2_2b" else (L,))


def test_layer_addresses_sub_layers_of_a_pattern_group():
    _, _, tm, tp = _models("gemma2_2b")
    for i in range(tm.cfg.num_layers):
        got = TF.layer(tp, i, tm.cfg)["attn"]["wq"]
        assert torch.equal(got, tp["layers"]["attn"]["wq"][i // 2, i % 2])


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jm, jp, tm, tp = _models(arch)
    toks = np.random.RandomState(4).randint(
        0, jm.cfg.vocab_size, size=(2, 37)).astype(np.int32)  # 37 > W
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


# (arch, prefill width, prompt lengths, cache length): for gemma2, a width
# within the window (16) and full rows past it, the cases where the
# reference's ring fill is right
PREFILL_CASES = [
    ("gemma2_2b", 12, [12, 5, 1], 32),
    ("gemma2_2b", 24, [24, 24], 40),
    ("qwen1_5_110b", 21, [21, 9, 1], 32),
    ("nemotron_4_340b", 21, [21, 9, 1], 32),
]


@pytest.mark.parametrize("arch,S,plens,max_len", PREFILL_CASES)
def test_prefill_caches_and_logits_match_reference(arch, S, plens, max_len):
    jm, jp, tm, tp = _models(arch)
    rng = np.random.RandomState(5)
    B = len(plens)
    toks = rng.randint(0, jm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    plens = np.asarray(plens, np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "prompt_lens": jnp.asarray(plens)},
                        jm.init_cache(B, max_len))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks), "prompt_lens": _t(plens)},
                        tm.init_cache(B, max_len))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    _close_tree(jc, tc)
    if arch == "gemma2_2b":
        assert set(tc) == {"k_local", "v_local", "k_global", "v_global"}
        assert tc["k_local"].shape[2] == min(16, max_len)


def test_ring_fill_takes_each_rows_own_last_window():
    """Prompts of 20 and 7 tokens in a prefill 32 wide, W = 16: the ring
    holds positions 16..19 and 4..15 of the first row at rows p % 16, and
    positions 0..6 (then pad columns 7..15) of the second."""
    pos = TF.ring_fill_positions(torch.tensor([20, 7, 0]), 16, 32)
    assert pos[0].tolist() == [16, 17, 18, 19] + list(range(4, 16))
    assert pos[1].tolist() == list(range(16))
    assert pos[2].tolist() == list(range(16))
    assert TF.ring_fill_positions(torch.tensor([5]), 16, 5).tolist() == \
        [list(range(5))]


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_decode_step_matches_reference(arch):
    """Logits and every cache row after one step on a random cache; for
    gemma2 the ring takes row kv_len % 16 (39 and 16 wrap) and the global
    cache row kv_len.  Slot 3 is inactive (kv_len 0)."""
    jm, jp, tm, tp = _models(arch)
    rng = np.random.RandomState(11)
    B, S = 4, 40
    cache = {n: (rng.randn(*a.shape) * 0.5).astype(np.float32)
             for n, a in tm.init_cache(B, S).items()}
    kv_len = np.array([5, 16, 39, 0], np.int32)
    token = rng.randint(0, jm.cfg.vocab_size, size=B).astype(np.int32)
    want, jc = jm.decode_step(jp, jnp.asarray(token),
                              {n: jnp.asarray(a) for n, a in cache.items()},
                              jnp.asarray(kv_len))
    got, tc = tm.decode_step(tp, _t(token), {n: _t(a) for n, a in
                                             cache.items()}, _t(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    _close_tree(jc, tc)


def _prefill_then_decode(m, params, toks, plens, S, G, max_len, t_):
    """Right-padded prefill of ``plens`` tokens a row at width S, then G
    teacher-forced decode steps; returns the G steps' logits."""
    B = len(plens)
    pt = np.zeros((B, S), np.int32)
    for b in range(B):
        pt[b, :plens[b]] = toks[b, :plens[b]]
    _, cache = m.prefill(params, {"tokens": t_(pt),
                                  "prompt_lens": t_(np.asarray(plens,
                                                               np.int32))},
                         m.init_cache(B, max_len))
    kv_len = np.asarray(plens, np.int32)
    out = []
    for t in range(G):
        nxt = np.array([toks[b, plens[b] + t] for b in range(B)], np.int32)
        lg, cache = m.decode_step(params, t_(nxt), cache, t_(kv_len))
        out.append(np.asarray(lg))
        kv_len = kv_len + 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_with_ragged_prompts(arch):
    """The reference's ``test_decode_matches_forward`` case (B 2, S 12, 3
    steps, prompts of 12 and 9): the port's decode equals its forward and
    the reference's decode."""
    jm, jp, tm, tp = _models(arch)
    B, S, G = 2, 12, 3
    toks = np.random.RandomState(7).randint(
        0, jm.cfg.vocab_size, size=(B, S + G)).astype(np.int32)
    plens = [S, S - 3]
    got = _prefill_then_decode(tm, tp, toks, plens, S, G, S + G + 2, _t)
    want = _prefill_then_decode(jm, jp, toks, plens, S, G, S + G + 2,
                                jnp.asarray)
    for b in range(B):
        ref, _ = tm.forward(tp, {"tokens": _t(toks[b:b + 1, :plens[b] + G])})
        for t in range(G):
            np.testing.assert_allclose(got[t][b], ref[0, plens[b] + t].numpy(),
                                       **ATOL)
            np.testing.assert_allclose(got[t][b], want[t][b], **ATOL)


def test_gemma2_ring_after_a_wrap_matches_reference_and_forward():
    """The reference's ``test_gemma2_ring_cache_wraparound`` case: one full
    row of W + 8 tokens, then 3 decode steps past the wrap."""
    jm, jp, tm, tp = _models("gemma2_2b")
    W = tm.cfg.attn.sliding_window
    S, G = W + 8, 3
    toks = np.random.RandomState(8).randint(
        0, jm.cfg.vocab_size, size=(1, S + G)).astype(np.int32)
    got = _prefill_then_decode(tm, tp, toks, [S], S, G, S + G + 2, _t)
    want = _prefill_then_decode(jm, jp, toks, [S], S, G, S + G + 2,
                                jnp.asarray)
    ref, _ = tm.forward(tp, {"tokens": _t(toks)})
    for t in range(G):
        np.testing.assert_allclose(got[t][0], ref[0, S + t].numpy(), **ATOL)
        np.testing.assert_allclose(got[t][0], want[t][0], **ATOL)


def test_pattern_refuses_paging_packing_and_the_hidden_state():
    _, _, tm, tp = _models("gemma2_2b")
    assert not supports_paging(tm)
    with pytest.raises(ValueError):
        SlotEngine(tm, lambda: tp, capacity=2, max_total_len=32,
                   max_gen_len=4, eos_id=-1, paged=True)
    toks = torch.ones((1, 8), dtype=torch.int32)
    batch = {"tokens": toks, "prompt_lens": torch.tensor([8]),
             "seg_ids": torch.zeros_like(toks), "positions": toks.long()}
    with pytest.raises(ValueError, match="packed"):
        tm.prefill_packed(tp, batch, tm.init_cache(1, 8))
    kv = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="local/global"):
        tm.decode_step_paged(tp, kv, {}, torch.zeros((1, 1), dtype=torch.int32),
                             kv)
    with pytest.raises(ValueError, match="return_hidden"):
        tm.decode_step(tp, kv, tm.init_cache(1, 8), kv, return_hidden=True)


# -- engines -------------------------------------------------------------------

KW = dict(capacity=4, max_total_len=64, max_gen_len=6, eos_id=-1,
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


def _prompts(n, seed, lo, hi):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 500, size=rng.randint(lo, hi + 1)).tolist()
            for _ in range(n)]


def _same_streams(a, b):
    assert set(a) == set(b)
    for uid in a:
        assert [x[0] for x in a[uid]] == [x[0] for x in b[uid]], uid
        assert [x[2:] for x in a[uid]] == [x[2:] for x in b[uid]], uid
        np.testing.assert_allclose([x[1] for x in b[uid]],
                                   [x[1] for x in a[uid]], atol=LP_TOL,
                                   rtol=0)


# (arch, engine options, prompt lengths): gemma2 takes the dense layout on
# prompts whose prefill stays within the window (<= 17 ids: 16 prefilled)
# and on prompts of exactly 32 ids (width 32 > W, every row full), the two
# cases where the reference's ring is right; the others run the paged and
# fused engines
ENGINE_CASES = [
    ("gemma2_2b", {}, (2, 17)),
    ("gemma2_2b", {}, (32, 32)),
    ("qwen1_5_110b", {}, (2, 40)),
    ("qwen1_5_110b", {"fused_sampling": True}, (2, 40)),
    ("nemotron_4_340b", {}, (2, 40)),
    ("nemotron_4_340b", {"fused_sampling": True}, (2, 40)),
]


@pytest.mark.parametrize("arch,kw,lens", ENGINE_CASES,
                         ids=["gemma2_within_window", "gemma2_32_ids",
                              "qwen1_5_paged", "qwen1_5_fused",
                              "nemotron_paged", "nemotron_fused"])
def test_greedy_streams_match_reference_engine(arch, kw, lens):
    """10 requests through 4 slots: greedy tokens equal, logprobs within
    ``LP_TOL``, the same prefill launches."""
    jm, jp, tm, tp = _models(arch)
    es = [(i, p) for i, p in enumerate(_prompts(10, 3, *lens))]
    args = dict(KW, **kw)
    je = JEngine(jm, lambda: jp, **args)
    te = SlotEngine(tm, lambda: tp, **args)
    assert te.paged == je.paged == (arch != "gemma2_2b")
    _same_streams(_serve(je, [JEntry(uid=i, prompt=p) for i, p in es]),
                  _serve(te, [TEntry(uid=i, prompt=p) for i, p in es]))
    assert te.prefill_launches == je.prefill_launches


def test_gemma2_engine_equals_its_own_forward_past_the_window():
    """A 20-id prompt (19 prefilled in a width-32 prefill, W = 16): where
    the reference's ring takes pad columns, the port's engine equals its
    plain forward (greedy tokens, logprobs within 1e-5)."""
    _, _, tm, tp = _models("gemma2_2b")
    prompt = _prompts(1, 9, 20, 20)[0]
    eng = SlotEngine(tm, lambda: tp, **dict(KW, max_total_len=48,
                                            max_gen_len=8))
    out = _serve(eng, [TEntry(uid=0, prompt=prompt)])[0]
    assert len(out) == 8
    toks = torch.tensor([prompt + [t for t, *_ in out]])
    logits, _ = tm.forward(tp, {"tokens": toks})
    lp = torch.log_softmax(logits[0, len(prompt) - 1:-1].double(), -1)
    gen = [t for t, *_ in out]
    assert lp.argmax(-1).tolist() == gen
    np.testing.assert_allclose([x[1] for x in out],
                               lp[torch.arange(len(gen)), gen].numpy(),
                               atol=OWN_FORWARD_TOL, rtol=0)


# -- one trainer update --------------------------------------------------------

def _entries(Entry, vocab, seed=0, n=6):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = int(rng.randint(1, 20))
        out.append(Entry(
            uid=100 + i,
            prompt=rng.randint(1, vocab, rng.randint(3, 12)).tolist(),
            meta=types.SimpleNamespace(prompt_id=i % 3),
            generated=rng.randint(1, vocab, g).tolist(),
            logprobs=(-4 * rng.rand(g)).tolist(),
            versions=rng.choice((0, 1, 2), g).tolist()))
    return out


def _reward(toks, meta):
    return (sum(toks) % 7) / 3.0


def test_gemma2_rl_update_matches_reference_trainer():
    """One ``RLTrainer.update`` (GRPO, AdamW) on the gemma2 smoke config:
    every metric within ``STEP_TOL``, every parameter leaf, (L/2, 2, ...)
    stacking included, within ``PARAM_TOL``."""
    jm, jp, tm, _ = _models("gemma2_2b")
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
