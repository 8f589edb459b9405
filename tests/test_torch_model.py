"""The port's dense transformer against the reference, on the CPU in f32.

Weights come from the reference's ``init_params`` and are carried over
with ``repro_torch.convert``; inputs are numpy arrays from a seed fed to
both packages.  Tolerance: atol 1e-4 (f32; only the order of sums
differs between the frameworks).  The int8 decode step has its own
bounds, stated in its test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from repro.configs import qwen3_0_6b as JQ
from repro.kernels.ref import gather_pages as jgather
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro.kernels.ref import quantize_pages_ref as jquantize
from repro.models.model import build_model as jbuild
from repro.rl.session import tiny_lm_config as jtiny
from repro.rollout.engine import SlotEngine as JEngine
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as TQ
from repro_torch.configs.base import get_config, tiny_lm_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model

ATOL = dict(atol=1e-4, rtol=1e-4)
_CACHE = {}


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _configs(name):
    if name == "qwen3_smoke":
        return (JQ.smoke_config().replace(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32),
                TQ.smoke_config().replace(param_dtype=torch.float32,
                                          compute_dtype=torch.float32))
    return jtiny(61, d_model=64, layers=2), tiny_lm_config(61, d_model=64,
                                                           layers=2)


def _models(name):
    if name not in _CACHE:
        jcfg, tcfg = _configs(name)
        jm = jbuild(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(1))
        tm = build_model(tcfg, device="cpu")
        tp = convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _CACHE[name] = (jm, jp, tm, tp)
    return _CACHE[name]


CONFIGS = ["qwen3_smoke", "tiny_lm"]


# -- configs, init, convert ---------------------------------------------------

def test_configs_match_reference_apart_from_dtype():
    from repro.configs.base import get_config as jget
    import dataclasses
    j, t = jget("qwen3_0_6b"), get_config("qwen3_0_6b")
    skip = {"param_dtype", "compute_dtype", "attn"}
    for f in dataclasses.fields(j):
        if f.name not in skip:
            assert getattr(j, f.name) == getattr(t, f.name), f.name
    assert dataclasses.asdict(j.attn) == dataclasses.asdict(t.attn)
    assert t.param_dtype == torch.bfloat16
    for name in CONFIGS:
        jc, tc = _configs(name)
        assert (jc.num_layers, jc.d_model, jc.num_heads, jc.num_kv_heads,
                jc.resolved_head_dim, jc.d_ff, jc.vocab_size) == \
            (tc.num_layers, tc.d_model, tc.num_heads, tc.num_kv_heads,
             tc.resolved_head_dim, tc.d_ff, tc.vocab_size)


def test_init_params_tree_and_scales_match_reference():
    jm, jp, tm, _ = _models("qwen3_smoke")
    tp = tm.init_params(torch.Generator().manual_seed(0))
    jn = jax.tree.map(np.asarray, jp)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + "/" + k)
            else:
                assert tuple(a[k].shape) == tuple(b[k].shape), path + k
                assert b[k].dtype == torch.float32
                sa, sb = float(np.std(a[k])), float(b[k].float().std())
                assert abs(sa - sb) <= 0.1 * max(sa, 1e-6), (path + k, sa, sb)
    walk(jn, tp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trips_exactly(dtype):
    cfg = JQ.smoke_config().replace(param_dtype=getattr(jnp, dtype))
    jn = jax.tree.map(np.asarray, jbuild(cfg).init_params(
        jax.random.PRNGKey(2)))
    tp = convert.from_jax_params(jn, device="cpu")
    back = convert.to_numpy(tp)
    again = convert.from_jax_params(back, device="cpu")

    def walk(a, t, b, t2):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], t[k], b[k], t2[k])
                continue
            assert t[k].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(np.asarray(a[k], np.float32), b[k])
            assert torch.equal(t2[k].to(t[k].dtype), t[k])
    walk(jn, tp, back, again)


# -- layers -------------------------------------------------------------------

def test_norms_and_rope_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 32).astype(np.float32)
    s = rng.rand(32).astype(np.float32) + 0.5
    b = rng.randn(32).astype(np.float32)
    np.testing.assert_allclose(L.rmsnorm(_t(x), _t(s), 1e-6).numpy(),
                               np.asarray(JL.rmsnorm(x, s, 1e-6)), **ATOL)
    np.testing.assert_allclose(L.layernorm(_t(x), _t(s), _t(b)).numpy(),
                               np.asarray(JL.layernorm(x, s, b)), **ATOL)
    pos = rng.randint(0, 2048, size=(2, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            L.apply_rope(_t(x), _t(pos), theta).numpy(),
            np.asarray(JL.apply_rope(x, pos, theta)), **ATOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_qkv_project_matches_reference(name):
    jm, jp, tm, tp = _models(name)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, jm.cfg.d_model).astype(np.float32)
    pos = rng.randint(0, 50, size=(2, 7)).astype(np.int32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    want = JL.qkv_project(jl["attn"], jm.cfg, x, pos)
    got = L.qkv_project(TF.layer(tp, 0, tm.cfg)["attn"], tm.cfg, _t(x), _t(pos))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ATOL)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("relu2", False), ("gelu", False)])
def test_mlp_matches_reference(act, gated):
    rng = np.random.RandomState(2)
    p = {"w_in": rng.randn(16, 40).astype(np.float32) / 4,
         "w_out": rng.randn(40, 16).astype(np.float32) / 6}
    if gated:
        p["w_gate"] = rng.randn(16, 40).astype(np.float32) / 4
    x = rng.randn(2, 3, 16).astype(np.float32)
    got = L.mlp({k: _t(v) for k, v in p.items()}, _t(x), act, gated)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JL.mlp(p, x, act, gated)), **ATOL)


def test_attention_layers_match_reference():
    rng = np.random.RandomState(3)
    q = rng.randn(2, 24, 4, 16).astype(np.float32)
    k = rng.randn(2, 24, 2, 16).astype(np.float32)
    v = rng.randn(2, 24, 2, 16).astype(np.float32)
    seg = np.repeat(np.array([[0, 1, -1], [0, 0, 1]]), 8, axis=1).astype(
        np.int32)
    for kw in ({}, {"window": 5, "softcap": 20.0}):
        got = L.full_attention(_t(q), _t(k), _t(v), seg_q=_t(seg),
                               seg_k=_t(seg), **kw)
        want = JL.full_attention(q, k, v, seg_q=seg, seg_k=seg, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    qd = q[:, 0]
    kv_len = np.array([0, 17], np.int32)
    for kw in ({}, {"window": 6}, {"softcap": 10.0}):
        got = L.decode_attention(_t(qd), _t(k), _t(v), _t(kv_len), **kw)
        want = JL.decode_attention(qd, k, v, kv_len, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_forward_logits_match_reference(name):
    jm, jp, tm, tp = _models(name)
    toks = np.random.RandomState(4).randint(
        0, jm.cfg.vocab_size, size=(2, 19)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_cache_and_logits_match_reference(name):
    jm, jp, tm, tp = _models(name)
    rng = np.random.RandomState(5)
    toks = rng.randint(0, jm.cfg.vocab_size, size=(3, 21)).astype(np.int32)
    plens = np.array([21, 9, 1], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "prompt_lens": jnp.asarray(plens)},
                        jm.init_cache(3, 32))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks), "prompt_lens": _t(plens)},
                        tm.init_cache(3, 32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    for name_ in ("k", "v"):
        np.testing.assert_allclose(tc[name_].numpy(), np.asarray(jc[name_]),
                                   **ATOL)
    none, _ = tm.prefill(tp, {"tokens": _t(toks), "prompt_lens": _t(plens)},
                         tm.init_cache(3, 32), return_logits=False)
    assert none is None


def _paged_setup(jm, seed):
    """A pool with distinct pages per slot; slot 3 inactive (kv_len 0,
    garbage page 0)."""
    cfg = jm.cfg
    rng = np.random.RandomState(seed)
    Lh, P, Kh, D = cfg.num_layers, 16, cfg.num_kv_heads, cfg.resolved_head_dim
    N, B, nb = 12, 4, 3
    pool = {n: (rng.randn(Lh, N, P, Kh, D) * 0.5).astype(np.float32)
            for n in ("k", "v")}
    for n in pool:
        pool[n][:, 0] = 0.0
    bt = np.zeros((B, nb), np.int32)
    bt[:3] = rng.permutation(np.arange(1, N))[:9].reshape(3, 3)
    kv_len = np.array([5, 16, 40, 0], np.int32)
    token = rng.randint(0, cfg.vocab_size, size=B).astype(np.int32)
    return pool, bt, kv_len, token


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("return_hidden", [False, True])
def test_paged_decode_step_matches_dense_decode_on_gathered_view(
        name, return_hidden):
    """The port decodes straight over the pool; the reference decodes a
    dense gathered view.  Same outputs, and the same rows written."""
    jm, jp, tm, tp = _models(name)
    pool, bt, kv_len, token = _paged_setup(jm, 6)
    view = {n: jnp.stack([jgather(jnp.asarray(pool[n][i]), jnp.asarray(bt))
                          for i in range(jm.cfg.num_layers)])
            for n in pool}
    want, new_view = JTF.decode_step(jp, jm.cfg, jnp.asarray(token), view,
                                     jnp.asarray(kv_len),
                                     return_hidden=return_hidden)
    tpool = {n: _t(a) for n, a in pool.items()}
    got, tpool = tm.decode_step_paged(tp, _t(token), tpool, _t(bt),
                                      _t(kv_len), return_hidden=return_hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    from repro_torch.kernels.ref import gather_pages
    for n in ("k", "v"):
        for i in range(jm.cfg.num_layers):
            g = gather_pages(tpool[n][i], _t(bt)).numpy()
            # active slots: every row equals the reference's updated view
            np.testing.assert_allclose(g[:3], np.asarray(new_view[n][i])[:3],
                                       **ATOL)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("return_hidden", [False, True])
def test_dense_decode_step_matches_reference(name, return_hidden):
    """The dense layout: logits (or hidden) and every cache row after the
    step, the written rows included, against the reference's
    ``decode_step`` on the same cache.  Slot 3 is inactive (kv_len 0)."""
    jm, jp, tm, tp = _models(name)
    cfg = jm.cfg
    rng = np.random.RandomState(11)
    B, S = 4, 40
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {n: (rng.randn(*shape) * 0.5).astype(np.float32)
             for n in ("k", "v")}
    kv_len = np.array([5, 16, 39, 0], np.int32)
    token = rng.randint(0, cfg.vocab_size, size=B).astype(np.int32)
    want, jc = JTF.decode_step(jp, cfg, jnp.asarray(token),
                               {n: jnp.asarray(a) for n, a in cache.items()},
                               jnp.asarray(kv_len),
                               return_hidden=return_hidden)
    tc = {n: _t(a) for n, a in cache.items()}
    got, tc = tm.decode_step(tp, _t(token), tc, _t(kv_len),
                             return_hidden=return_hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **ATOL)
        assert not np.array_equal(tc[n].numpy(), cache[n])


INT8_TIE_CELLS = 2        # cells allowed one int8 step apart, per pool


def test_int8_paged_decode_step_against_reference_engine():
    """One int8 ``decode_step_paged`` against the reference engine's
    ``_paged_decode_fn`` on the same int8 pool and scales.

    Both attend over the old rows at their page's scale with the new row
    unquantised, and requantise the written page afterwards, so in f32:
    * greedy tokens equal, logprobs within 1e-5 (f32 sum order);
    * every layer's int8 bytes equal, except cells of a written page
      that sit at a rounding tie, where the two frameworks' f32 sum
      orders may round one step apart: at most ``INT8_TIE_CELLS`` per
      pool, each one step (0 such cells in this case);
    * scales to f32 rounding (rtol 1e-6): a scale that grew is the new
      row's amax / 127, computed in another sum order;
    * pages no slot wrote are untouched.
    """
    jm, jp, tm, tp = _models("qwen3_smoke")
    cfg = jm.cfg
    pool, bt, kv_len, token = _paged_setup(jm, 6)
    N, Lh = pool["k"].shape[1], cfg.num_layers
    q8, sc = {}, {}
    for n, a in pool.items():
        qs = [jquantize(jnp.asarray(a[i])) for i in range(Lh)]
        q8[n] = np.stack([np.asarray(x) for x, _ in qs])
        sc[n] = np.stack([np.asarray(y) for _, y in qs])
    je = JEngine(jm, lambda: jp, capacity=4, max_total_len=64, max_gen_len=4,
                 eos_id=-1, temperature=0.0, kv_quant="int8", num_pages=N)
    jtok, jlp, jc, js = je._paged_decode_fn(
        jp, jnp.asarray(token), {n: jnp.asarray(a) for n, a in q8.items()},
        {n: jnp.asarray(a) for n, a in sc.items()}, jnp.asarray(bt),
        jnp.asarray(kv_len), jax.random.PRNGKey(0))
    tpool = {n: _t(a) for n, a in q8.items()}
    tsc = {n: _t(a) for n, a in sc.items()}
    logits, _ = tm.decode_step_paged(tp, _t(token), tpool, _t(bt),
                                     _t(kv_len), scales=tsc)
    lps = torch.log_softmax(logits.float(), -1)
    tok = lps.argmax(-1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lps.gather(1, tok[:, None])[:, 0].numpy(),
                               np.asarray(jlp), atol=1e-5, rtol=0)
    written = bt[np.arange(4), kv_len // pool["k"].shape[2]]
    for n in ("k", "v"):
        got, want = tpool[n].numpy(), np.asarray(jc[n])
        gs, ws = tsc[n].numpy(), np.asarray(js[n])
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
        diff = got != want
        assert diff.sum() <= INT8_TIE_CELLS, (n, int(diff.sum()))
        if diff.any():
            pages = np.nonzero(diff)[1]
            assert np.all(np.abs(got[diff].astype(np.int32)
                                 - want[diff].astype(np.int32)) == 1), n
            assert set(pages.tolist()) <= set(written.tolist()), (n, pages)
        assert not np.array_equal(got[0], q8[n][0])       # pages were written
        untouched = np.setdiff1d(np.arange(N), written)
        np.testing.assert_array_equal(got[:, untouched], q8[n][:, untouched])


def test_packed_prefill_kv_equals_solo_prefill():
    jm, jp, tm, tp = _models("qwen3_smoke")
    rng = np.random.RandomState(7)
    a = rng.randint(1, 500, size=13).tolist()
    b = rng.randint(1, 500, size=20).tolist()
    W = 64
    toks = np.zeros((1, W), np.int32)
    seg = np.full((1, W), -1, np.int32)
    pos = np.zeros((1, W), np.int32)
    toks[0, :13], toks[0, 16:36] = a, b
    seg[0, :16], seg[0, 16:48] = 0, 1
    pos[0, :16], pos[0, 16:48] = np.arange(16), np.arange(32)
    _, packed = tm.prefill_packed(
        tp, {"tokens": _t(toks), "prompt_lens": _t(np.array([36])),
             "seg_ids": _t(seg), "positions": _t(pos)}, tm.init_cache(1, W),
        return_logits=False)
    for off, p in ((0, a), (16, b)):
        solo_t = np.zeros((1, 32), np.int32)
        solo_t[0, :len(p)] = p
        _, solo = tm.prefill(tp, {"tokens": _t(solo_t),
                                  "prompt_lens": _t(np.array([len(p)]))},
                             tm.init_cache(1, 32), return_logits=False)
        for n in ("k", "v"):
            np.testing.assert_allclose(
                packed[n][:, 0, off:off + len(p)].numpy(),
                solo[n][:, 0, :len(p)].numpy(), **ATOL)


def test_entry_points_refuse_the_cpu_unless_asked():
    cfg = tiny_lm_config(11, d_model=16, layers=1, heads=2)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(NotImplementedError):
        build_model(cfg.replace(family="no_such_family"), device="cpu")


def test_convert_lands_on_the_card_unless_the_cpu_is_asked():
    """``from_jax_params`` resolves its device as the entry points do:
    the card by default; without one, only ``device="cpu"`` works."""
    tree = {"a": np.ones((2, 3), np.float32), "b": {"c": np.zeros(4, np.int32)}}
    if torch.cuda.is_available():
        assert convert.from_jax_params(tree)["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.from_jax_params(tree)
    out = convert.from_jax_params(tree, device="cpu")
    assert out["b"]["c"].device.type == "cpu" and out["a"].shape == (2, 3)
