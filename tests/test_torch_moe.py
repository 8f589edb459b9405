"""The MoE family on the port (``repro_torch/models/moe.py`` and the
transformer around it), against the reference, on the CPU in f32:
Granite-MoE-3B-A800M and Qwen3-MoE-235B-A22B at their ``smoke_config()``
(2 layers, d 128, 4 experts, top-2).

* The layer: ``_route`` (gates, idx, aux; ties go to the lowest index),
  ``_capacity``, ``_dispatch_indices``, ``moe_mlp_dense`` and
  ``moe_mlp_ref`` at capacity factors 8.0 (no drops), 1.25 and 0.25
  (drops).  ``idx`` and ``keep`` exactly equal; outputs, gates and aux
  within ``LAYER_TOL`` (atol = rtol = 1e-5: only the order of f32 sums
  differs).
* The parameter dtypes of a bf16 tree (router f32) in both packages and
  through ``convert.from_jax_params``.
* The model: forward logits and summed aux, prefill caches, one decode
  step, within ``ATOL`` (1e-4, ``tests/test_torch_model.py``'s).
* Greedy streams of the engines against the reference's: in
  ``test_torch_moe_engines.py``, with this file's models and tolerances.
* One trainer update: the loss with the router losses, every gradient
  (the router's included) within ``STEP_TOL`` and every parameter after
  AdamW within ``PARAM_TOL`` of ``tests/test_torch_rl.py``.

Both config sets' parity with the reference and their init trees, key
for key, are in ``tests/test_torch_families.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from repro.configs.base import get_smoke_config as jget_smoke
from repro.core.buffer import BufferEntry as JEntry
from repro.models import moe as JMOE
from repro.models.model import build_model as jbuild
from repro.rl import losses as JL
from repro.rl import trainer as JT
from repro_torch import convert
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.buffer import BufferEntry as TEntry
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model
from repro_torch.rl import losses as TL
from repro_torch.rl import trainer as TT
from repro_torch.train import optimizer as TO

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = dict(atol=1e-4, rtol=1e-4)
LP_TOL = 1e-4
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=0.1 * 3e-4)     # 0.1 lr (AdamWConfig())
ARCHS = ["granite_moe_3b_a800m", "qwen3_moe_235b_a22b"]
_CACHE = {}


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _cfgs(arch, cf=None, dtype="float32"):
    jcfg = jget_smoke(arch).replace(param_dtype=getattr(jnp, dtype),
                                    compute_dtype=getattr(jnp, dtype))
    tcfg = get_smoke_config(arch).replace(param_dtype=getattr(torch, dtype),
                                          compute_dtype=getattr(torch, dtype))
    if cf is not None:
        jcfg = jcfg.replace(moe=jcfg.moe.__class__(
            **{**jcfg.moe.__dict__, "capacity_factor": cf}))
        tcfg = tcfg.replace(moe=tcfg.moe.__class__(
            **{**tcfg.moe.__dict__, "capacity_factor": cf}))
    return jcfg, tcfg


def _models(arch, cf=None):
    """(jax model, jax params, port model, port params); the weights do not
    depend on the capacity factor, so every factor shares one draw."""
    if arch not in _CACHE:
        jcfg, _ = _cfgs(arch)
        jp = jbuild(jcfg).init_params(jax.random.PRNGKey(1))
        _CACHE[arch] = (jp, convert.from_jax_params(
            jax.tree.map(np.asarray, jp), device="cpu"))
    jp, tp = _CACHE[arch]
    jcfg, tcfg = _cfgs(arch, cf)
    return jbuild(jcfg), jp, build_model(tcfg, device="cpu"), tp


def _layer0_mlp(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["mlp"]),
            {k: v[0] for k, v in tp["layers"]["mlp"].items()})


# -- the layer -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_moe_layer_matches_reference(arch, cf):
    """Routing, capacity, dispatch, the layer and the no-drop oracle on a
    (3, 11, d) input; at 1.25 and 0.25 the reference drops pairs and the
    port drops the same ones."""
    jm, jp, tm, tp = _models(arch, cf)
    jmlp, tmlp = _layer0_mlp(jp, tp)
    x = np.random.RandomState(int(cf * 4)).randn(
        3, 11, jm.cfg.d_model).astype(np.float32)
    x2d = x.reshape(-1, jm.cfg.d_model)
    jg, ji, jaux = JMOE._route(jmlp, jm.cfg, jnp.asarray(x2d))
    tg, ti, taux = MOE._route(tmlp, tm.cfg, _t(x2d))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **LAYER_TOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   err_msg=k, **LAYER_TOL)
    T, E = x2d.shape[0], jm.cfg.moe.num_experts
    C = JMOE._capacity(jm.cfg, T)
    assert MOE._capacity(tm.cfg, T) == C
    jpos, jkeep = JMOE._dispatch_indices(ji, E, C)
    tpos, tkeep = MOE._dispatch_indices(ti, E, C)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    dropped = int((~np.asarray(jkeep)).sum())
    assert (dropped == 0) == (cf == 8.0), dropped
    jy, jaux = JMOE.moe_mlp_dense(jmlp, jm.cfg, jnp.asarray(x))
    ty, taux = MOE.moe_mlp_dense(tmlp, tm.cfg, _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   err_msg=k, **LAYER_TOL)
    tref = MOE.moe_mlp_ref(tmlp, tm.cfg, _t(x))
    np.testing.assert_allclose(
        tref.numpy(), np.asarray(JMOE.moe_mlp_ref(jmlp, jm.cfg,
                                                  jnp.asarray(x))),
        **LAYER_TOL)
    if not dropped:                     # the layer is the oracle
        np.testing.assert_allclose(ty.numpy(), tref.numpy(), **LAYER_TOL)
    else:
        assert not np.allclose(ty.numpy(), tref.numpy(), **LAYER_TOL)


def test_dispatch_indices_keep_the_first_pairs_of_an_expert():
    """The reference's case: three tokens for expert 0 at capacity 2, the
    third dropped; then a wider one against the reference."""
    pos, keep = MOE._dispatch_indices(torch.tensor([[0], [0], [0], [1]]),
                                      E=2, C=2)
    assert pos[:, 0].tolist() == [0, 1, 2, 0]
    assert keep[:, 0].tolist() == [True, True, False, True]
    idx = np.random.RandomState(0).randint(0, 5, size=(40, 3))
    for C in (4, 9, 30):
        jpos, jkeep = JMOE._dispatch_indices(jnp.asarray(idx), 5, C)
        tpos, tkeep = MOE._dispatch_indices(_t(idx), 5, C)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


def test_router_ties_go_to_the_lowest_expert():
    """A zero router makes every probability equal: the reference's
    ``top_k`` picks experts 0 and 1, and so does the port; with columns 1
    and 3 equal and largest, 1 comes before 3."""
    jm, jp, tm, tp = _models("granite_moe_3b_a800m")
    jmlp, tmlp = _layer0_mlp(jp, tp)
    x = np.random.RandomState(1).randn(6, jm.cfg.d_model).astype(np.float32)
    for router in (np.zeros((jm.cfg.d_model, 4), np.float32),
                   np.stack([np.full(jm.cfg.d_model, v, np.float32)
                             for v in (0.1, 0.5, -0.2, 0.5)], 1)):
        x_pos = np.abs(x)
        _, ji, _ = JMOE._route(dict(jmlp, router=jnp.asarray(router)),
                               jm.cfg, jnp.asarray(x_pos))
        _, ti, _ = MOE._route(dict(tmlp, router=_t(router)), tm.cfg,
                              _t(x_pos))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.tolist() == [[0, 1] if not router.any() else [1, 3]] * 6
        vals, idx = MOE.top_k_lowest_first(torch.tensor(
            [[1.0, 2.0, 2.0, 0.0, 2.0]]), 3)
        assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[2.0] * 3]


# -- parameters ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_tree_keeps_an_f32_router_through_convert(arch):
    """In a bf16 tree the router is f32 in both packages' init, and
    ``from_jax_params`` keeps each leaf's own dtype."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tp = build_model(tcfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    got = convert.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for tree in (tp, got):
        mlp = tree["layers"]["mlp"]
        assert mlp["router"].dtype == torch.float32
        assert {mlp[k].dtype for k in ("w_in", "w_gate", "w_out")} == \
            {torch.bfloat16}
        assert tree["embed"].dtype == torch.bfloat16
    assert np.asarray(jp["layers"]["mlp"]["router"]).dtype == np.float32
    for a, b in zip(jax.tree.leaves(jp), TO.tree_leaves(got)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a).astype(np.float32))


def test_moe_with_the_local_global_pattern_is_refused():
    _, tcfg = _cfgs("granite_moe_3b_a800m")
    bad = tcfg.replace(attn=tcfg.attn.__class__(layer_pattern="local_global",
                                                sliding_window=8))
    with pytest.raises(NotImplementedError, match="MoE"):
        build_model(bad, device="cpu")


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_forward_logits_and_aux_match_reference(arch, cf):
    jm, jp, tm, tp = _models(arch, cf)
    toks = np.random.RandomState(4).randint(
        0, jm.cfg.vocab_size, size=(2, 23)).astype(np.int32)
    want, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, taux = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   err_msg=k, **ATOL)
        assert float(taux[k]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_step_match_reference(arch):
    """A ragged prefill at width 21 (the MoE sees all 3 x 21 tokens), then
    one decode step on the dense cache with slot 3 inactive (kv_len 0),
    at the drop-heavy capacity factor 0.5."""
    jm, jp, tm, tp = _models(arch, 0.5)
    rng = np.random.RandomState(5)
    plens = np.asarray([21, 9, 1], np.int32)
    toks = rng.randint(0, jm.cfg.vocab_size, size=(3, 21)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "prompt_lens": jnp.asarray(plens)},
                        jm.init_cache(3, 32))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks), "prompt_lens": _t(plens)},
                        tm.init_cache(3, 32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **ATOL)
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
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **ATOL)


def test_paged_step_idle_rows_attend_their_own_row():
    """Inactive slots all write row 0 of the garbage page; in the MoE
    family each must still attend its own new row, as the reference's
    does, or its hidden state (which takes expert capacity) changes.  Two
    idle slots with different tokens: logits equal the dense step's, where
    each slot has rows of its own."""
    _, _, tm, tp = _models("granite_moe_3b_a800m", 0.5)
    B, P = 4, 16
    token = torch.tensor([7, 100, 300, 450], dtype=torch.int32)
    kv_len = torch.tensor([3, 0, 5, 0], dtype=torch.int32)
    pool = tm.init_cache(9, P)
    for t in pool.values():
        t.normal_(generator=torch.Generator().manual_seed(2))
    bt = torch.tensor([[1], [0], [2], [0]], dtype=torch.int32)
    dense = {n: torch.zeros((t.shape[0], B, P) + t.shape[3:])
             for n, t in pool.items()}
    for n in pool:
        for b in range(B):
            dense[n][:, b] = pool[n][:, int(bt[b, 0])]
    got, _ = tm.decode_step_paged(tp, token, pool, bt, kv_len)
    want, _ = tm.decode_step(tp, token, dense, kv_len)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LAYER_TOL)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_rl_update_matches_reference_trainer(arch):
    """The loss with the router losses and its gradient (the router's
    included, and non-zero), then one ``RLTrainer.update`` (GRPO, AdamW)
    at the drop-heavy capacity factor 0.5."""
    jm, jp, tm, _ = _models(arch, 0.5)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    vocab = jm.cfg.vocab_size
    jb, _ = JT.entries_to_batch(_entries(JEntry, vocab), _reward, 0, 64)
    tb, _ = TT.entries_to_batch(_entries(TEntry, vocab), _reward, 0, 64,
                                device="cpu")

    def jloss(p):
        logits, aux = jm.forward(p, jb)
        return JL.total_loss(logits, aux, jb, JL.LossConfig())

    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp)

    def tloss(p, batch):
        logits, aux = tm.forward(p, batch)
        return TL.total_loss(logits, aux, batch, TL.LossConfig())
    (tl, tmet), tg = TT.value_and_grad(tloss, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), **STEP_TOL)
    aux_part = float((tmet["total_loss"] - tmet["policy_loss"]).detach())
    assert aux_part > 0                     # the router losses are in it
    names = [p for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert len(tg) == len(names)
    for path, a, b in zip(names, jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   err_msg=jax.tree_util.keystr(path),
                                   **STEP_TOL)
    router = [i for i, t in enumerate(TO.tree_leaves(tp))
              if t is tp["layers"]["mlp"]["router"]]
    assert len(router) == 1 and float(tg[router[0]].abs().max()) > 0

    kw = dict(pad_id=0, max_len=64, advantage_kind="grpo", opt_cfg=None)
    jt = JT.RLTrainer(jm, jp, _reward, **kw)
    tt = TT.RLTrainer(tm, tp, _reward, **kw)
    jrec = jt.update(_entries(JEntry, vocab), 0)
    trec = tt.update(_entries(TEntry, vocab), 0)
    assert set(jrec) == set(trec)
    for k in jrec:
        np.testing.assert_allclose(trec[k], jrec[k], err_msg=k, **STEP_TOL)
    for a, b in zip(jax.tree.leaves(jt.params()),
                    TO.tree_leaves(tt.params())):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   **PARAM_TOL)
    assert TF.layer(tt.params(), 0, tm.cfg)["mlp"]["router"].dtype == \
        torch.float32
