"""The vision-language and audio families on the port, against the
reference, on the CPU in f32: Phi-3-Vision-4.2B (the dense backbone
behind stub patch rows) and Whisper-small (encoder, decoder,
cross-attention), each at its ``smoke_config()``.

Weights come from the reference's ``init_params`` and are carried over
with ``repro_torch.convert``; inputs are numpy arrays from a seed fed to
both packages, patch rows and frames 0.1 N(0, 1) as in the reference's
``tests/test_models.py``.  Tolerances are ``tests/test_torch_families.py``'s:
atol = rtol = 1e-4 (``ATOL``, f32; only the order of sums differs
between the frameworks), engine logprobs ``LP_TOL`` (1e-4), the
trainer's ``STEP_TOL``/``PARAM_TOL``.

As in the reference, the engines feed zero stub rows, the vlm's patch
rows sit in the cache before each prompt (a slot's ``kv_len`` counts
them), and the trainer scores tokens without them.
"""
import dataclasses

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
from repro.models import layers as JL
from repro.models import whisper as JWH
from repro.rl import losses as JLO
from repro.rl import trainer as JT
from repro.rollout.engine import SlotEngine as JEngine
from repro.train import optimizer as JO
from repro_torch import convert
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.buffer import BufferEntry as TEntry
from repro_torch.models import layers as L
from repro_torch.models import whisper as WH
from repro_torch.models.model import supports_paging
from repro_torch.rl import losses as TLO
from repro_torch.rl import trainer as TT
from repro_torch.rollout.engine import SlotEngine
from repro_torch.train import optimizer as TO
from test_torch_families import (ATOL, KW, PARAM_TOL, STEP_TOL,
                                 _close_tree, _entries, _models, _prompts,
                                 _reward, _same_streams, _serve, _t)

VLM, AUDIO = "phi_3_vision_4_2b", "whisper_small"
ARCHS = [VLM, AUDIO]


def _stub(cfg, B, seed):
    """0.1 N(0, 1) patch rows or frames (B, num_stub_positions, d)."""
    return (0.1 * np.random.RandomState(seed).randn(
        B, cfg.num_stub_positions, cfg.d_model)).astype(np.float32)


def _stub_key(cfg):
    return "patch_embeds" if cfg.family == "vlm" else "frames"


def _batches(cfg, toks, seed, **extra):
    """The same batch for both packages: tokens, the stub rows and any
    other arrays given."""
    arrays = dict(tokens=toks, **extra)
    arrays[_stub_key(cfg)] = _stub(cfg, toks.shape[0], seed)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: _t(v) for k, v in arrays.items()})


# -- configs, init, conversion ---------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_apart_from_dtype(arch):
    for j, t in ((jget_config(arch), get_config(arch)),
                 (jget_smoke(arch), get_smoke_config(arch))):
        for f in dataclasses.fields(j):
            if f.name not in ("param_dtype", "compute_dtype", "attn"):
                assert getattr(j, f.name) == getattr(t, f.name), f.name
        assert dataclasses.asdict(j.attn) == dataclasses.asdict(t.attn)
        assert t.param_dtype == t.compute_dtype == torch.bfloat16
    aliases = [a for a, m in JALIASES.items() if m == arch]
    assert aliases and all(get_config(a) == get_config(arch) for a in aliases)


@pytest.mark.parametrize("arch", ARCHS)
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
    if arch == AUDIO:
        cfg = tm.cfg
        assert tp["enc_layers"]["ln1"]["bias"].shape == (cfg.encoder_layers,
                                                         cfg.d_model)
        assert set(tp["dec_layers"]) == {"attn", "mlp", "ln1", "ln2",
                                         "xattn", "ln_x"}


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips_the_tree(arch):
    """Every leaf of the reference's tree (whisper's ``enc_layers``,
    ``dec_layers`` with ``xattn``/``ln_x``, ``pos_embed``, layernorm
    ``scale``/``bias``) goes to torch and back unchanged, in f32 and in
    bf16."""
    _, jp, _, tp = _models(arch)
    jn = jax.tree.map(np.asarray, jp)
    back = convert.to_numpy(tp)
    assert jax.tree.structure(jn) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(jn), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    jb = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp)
    tb = convert.from_jax_params(jb, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in TO.tree_leaves(tb))
    for a, b in zip(jax.tree.leaves(jb), jax.tree.leaves(convert.to_numpy(tb))):
        np.testing.assert_array_equal(a.astype(np.float32), b)


@pytest.mark.parametrize("length,d", [(32, 128), (1500, 768), (7, 6)])
def test_sinusoidal_embedding_matches_reference(length, d):
    """Within 1e-5, or two f32 ulps of the frequency times the position:
    the frameworks' f32 ``exp`` may differ by an ulp, which moves the
    angle at position p by p ulps of the frequency (1.2e-4 at p 1499)."""
    np.testing.assert_allclose(L.sinusoidal_embedding(length, d).numpy(),
                               np.asarray(JL.sinusoidal_embedding(length, d)),
                               atol=max(1e-5, length * 2.0 ** -23), rtol=0)


# -- the vision-language model ---------------------------------------------------

def test_vlm_forward_with_and_without_patch_rows_matches_reference():
    """Logits over [patch rows, tokens] (B, P + S, V) with random patch
    rows, and over the tokens alone without them."""
    jm, jp, tm, tp = _models(VLM)
    toks = np.random.RandomState(4).randint(
        0, jm.cfg.vocab_size, size=(2, 21)).astype(np.int32)
    jb, tb = _batches(jm.cfg, toks, 5)
    want, _ = jm.forward(jp, jb)
    got, _ = tm.forward(tp, tb)
    assert got.shape == (2, jm.cfg.num_stub_positions + 21, jm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


def test_vlm_prefill_caches_and_logits_match_reference():
    """P patch rows then a right-padded width of 21: P + 21 cache rows
    filled, the logits at every position."""
    jm, jp, tm, tp = _models(VLM)
    rng = np.random.RandomState(6)
    plens = np.array([21, 9, 1], np.int32)
    toks = rng.randint(0, jm.cfg.vocab_size, size=(3, 21)).astype(np.int32)
    jb, tb = _batches(jm.cfg, toks, 7, prompt_lens=plens)
    max_len = 21 + tm.prefill_extra + 5
    jl, jc = jm.prefill(jp, jb, jm.init_cache(3, max_len))
    tl, tc = tm.prefill(tp, tb, tm.init_cache(3, max_len))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    _close_tree(jc, tc)
    assert tm.prefill_extra == jm.prefill_extra == jm.cfg.num_stub_positions


# -- the audio model ---------------------------------------------------------------

def test_whisper_encode_cross_kv_and_forward_match_reference():
    jm, jp, tm, tp = _models(AUDIO)
    cfg = jm.cfg
    frames = _stub(cfg, 2, 8)
    enc_j = JWH.encode(jp, cfg, jnp.asarray(frames))
    enc_t = WH.encode(tp, tm.cfg, _t(frames))
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), **ATOL)
    for a, b in zip(JWH.cross_kv(jp, cfg, enc_j), WH.cross_kv(tp, tm.cfg,
                                                               enc_t)):
        assert tuple(b.shape) == (cfg.num_layers, 2, cfg.encoder_positions,
                                  cfg.num_kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **ATOL)
    toks = np.random.RandomState(9).randint(
        0, cfg.vocab_size, size=(2, 19)).astype(np.int32)
    jb, tb = _batches(cfg, toks, 8)
    want, _ = jm.forward(jp, jb)
    got, _ = tm.forward(tp, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


def test_whisper_prefill_caches_match_reference():
    """All four keys: the decoder's own rows and the cross K/V the
    prefill encodes from the frames."""
    jm, jp, tm, tp = _models(AUDIO)
    rng = np.random.RandomState(10)
    plens = np.array([21, 9, 1], np.int32)
    toks = rng.randint(0, jm.cfg.vocab_size, size=(3, 21)).astype(np.int32)
    jb, tb = _batches(jm.cfg, toks, 11, prompt_lens=plens)
    jl, jc = jm.prefill(jp, jb, jm.init_cache(3, 32))
    tl, tc = tm.prefill(tp, tb, tm.init_cache(3, 32))
    assert set(tc) == {"k", "v", "k_x", "v_x"}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    _close_tree(jc, tc)


# -- decode against forward (both families) --------------------------------------

def _decode_run(m, params, batch, toks, plens, S, G, t_):
    """Right-padded prefill of ``plens`` tokens a row at width S (stub
    rows of ``batch``), then G teacher-forced decode steps."""
    B = len(plens)
    pt = np.zeros((B, S), np.int32)
    for b in range(B):
        pt[b, :plens[b]] = toks[b, :plens[b]]
    batch = dict(batch, tokens=t_(pt), prompt_lens=t_(np.asarray(plens,
                                                                 np.int32)))
    _, cache = m.prefill(params, batch,
                         m.init_cache(B, S + G + 2 + m.prefill_extra))
    kv_len = np.asarray(plens, np.int32) + m.prefill_extra
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
    steps, prompts of 12 and 9) with random patch rows or frames: the
    port's decode equals its forward (at the offset of the patch rows)
    and the reference's decode."""
    jm, jp, tm, tp = _models(arch)
    cfg = jm.cfg
    B, S, G = 2, 12, 3
    toks = np.random.RandomState(7).randint(
        0, cfg.vocab_size, size=(B, S + G)).astype(np.int32)
    plens = [S, S - 3]
    stub = _stub(cfg, B, 12)
    key = _stub_key(cfg)
    got = _decode_run(tm, tp, {key: _t(stub)}, toks, plens, S, G, _t)
    want = _decode_run(jm, jp, {key: jnp.asarray(stub)}, toks, plens, S, G,
                       jnp.asarray)
    off = tm.prefill_extra
    for b in range(B):
        ref, _ = tm.forward(tp, {"tokens": _t(toks[b:b + 1, :plens[b] + G]),
                                 key: _t(stub[b:b + 1])})
        for t in range(G):
            np.testing.assert_allclose(got[t][b],
                                       ref[0, off + plens[b] + t].numpy(),
                                       **ATOL)
            np.testing.assert_allclose(got[t][b], want[t][b], **ATOL)


# -- engines -----------------------------------------------------------------------

# (arch, engine options, prompt lengths): the vlm's prefill width plus its
# 16 patch rows stays within max_total_len (64), as the reference's dense
# sub-cache needs
ENGINE_CASES = [
    (VLM, {}, (2, 30)),
    (VLM, {"fused_sampling": True}, (2, 30)),
    (VLM, {"paged": False}, (2, 30)),
    (VLM, {"kv_quant": "int8"}, (2, 30)),
    (AUDIO, {}, (2, 40)),
]


@pytest.mark.parametrize("arch,kw,lens", ENGINE_CASES,
                         ids=["vlm_paged", "vlm_fused", "vlm_dense",
                              "vlm_int8", "whisper_dense"])
def test_greedy_streams_match_reference_engine(arch, kw, lens):
    """10 requests through 4 slots: greedy tokens equal, logprobs within
    ``LP_TOL``, the same prefill launches; the vlm's slots count the patch
    rows in ``kv_len`` (ending by length 16 rows earlier)."""
    jm, jp, tm, tp = _models(arch)
    es = [(i, p) for i, p in enumerate(_prompts(10, 3, *lens))]
    args = dict(KW, **kw)
    je = JEngine(jm, lambda: jp, **args)
    te = SlotEngine(tm, lambda: tp, **args)
    assert te.paged == je.paged == (arch == VLM and kw.get("paged", True))
    _same_streams(_serve(je, [JEntry(uid=i, prompt=p) for i, p in es]),
                  _serve(te, [TEntry(uid=i, prompt=p) for i, p in es]))
    assert te.prefill_launches == je.prefill_launches


def test_vlm_migration_carries_the_patch_rows_pages():
    """An active vlm entry exported after 2 steps and imported into a
    fresh engine continues token for token as if never moved: its handle
    holds the pages of its patch rows and its tokens."""
    _, _, tm, tp = _models(VLM)
    prompt = _prompts(1, 13, 20, 20)[0]
    args = dict(KW, max_gen_len=8)
    solo = _serve(SlotEngine(tm, lambda: tp, **args),
                  [TEntry(uid=0, prompt=prompt)])[0]
    a = SlotEngine(tm, lambda: tp, **args)
    a.submit([TEntry(uid=0, prompt=prompt)], 0)
    moved = [(ev.token, ev.logprob, ev.done, ev.finish_reason)
             for _ in range(2) for ev in a.step()]
    h = a.export_entry(0)
    P = a.page_size
    assert h["slot"]["kv_len"] == len(prompt) + 1 + tm.prefill_extra
    assert h["pages_k"].shape[1] == -(-h["slot"]["kv_len"] // P)
    a.discard_entry(0)
    b = SlotEngine(tm, lambda: tp, **args)
    assert b.import_entry(h)
    while b.active_uids():
        moved += [(ev.token, ev.logprob, ev.done, ev.finish_reason)
                  for ev in b.step()]
    _same_streams({0: solo}, {0: moved})


def test_refusals_packed_prefill_for_vlm_pages_for_whisper():
    _, _, vm, vp = _models(VLM)
    assert vm.prefill_packed is None and supports_paging(vm)
    with pytest.raises(ValueError, match="stub"):
        SlotEngine(vm, lambda: vp, packed_prefill=True, **KW)
    _, _, am, ap = _models(AUDIO)
    assert not supports_paging(am)
    assert set(am.init_cache(1, 4)) == {"k", "v", "k_x", "v_x"}
    assert am.prefill_packed is None and am.decode_step_paged is None
    for kw in ({"paged": True}, {"fused_sampling": True},
               {"kv_quant": "int8"}, {"packed_prefill": True}):
        with pytest.raises(ValueError):
            SlotEngine(am, lambda: ap, **dict(KW, **kw))
    assert not SlotEngine(am, lambda: ap, **KW).paged


# -- the trainer ---------------------------------------------------------------------

def test_vlm_rl_update_matches_reference_trainer():
    """One ``RLTrainer.update`` (GRPO, AdamW) on the vlm smoke config: its
    batch has no patch rows, as the reference's has none; every metric
    within ``STEP_TOL``, every parameter leaf within ``PARAM_TOL``."""
    jm, jp, tm, _ = _models(VLM)
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
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   **PARAM_TOL)


def test_vlm_train_step_drops_the_patch_positions_as_the_reference():
    """``make_train_step`` on a batch with patch rows scores only the
    token positions: metrics and parameters as the reference's step."""
    jm, jp, tm, _ = _models(VLM)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(14)
    B, S = 2, 16
    toks = rng.randint(1, jm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, :4] = 0.0
    jb, tb = _batches(jm.cfg, toks, 15, loss_mask=mask,
                      advantages=rng.randn(B, S).astype(np.float32),
                      old_logprobs=np.full((B, S), -2.0, np.float32))
    jcfg, tcfg = JO.AdamWConfig(), TO.AdamWConfig()
    jp2, _, jmet = JT.make_train_step(jm, JLO.LossConfig(), jcfg)(
        jp, JO.init_opt_state(jp, jcfg), jb)
    tp2, _, tmet = TT.make_train_step(tm, TLO.LossConfig(), tcfg)(
        tp, TO.init_opt_state(tp, tcfg), tb)
    assert set(jmet) == set(tmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), err_msg=k,
                                   **STEP_TOL)
    for a, b in zip(jax.tree.leaves(jp2), TO.tree_leaves(tp2)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   **PARAM_TOL)
