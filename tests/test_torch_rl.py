"""The port's RL update path against the reference, on the CPU.

The same numpy inputs (seeded) go through the JAX function and its
counterpart in ``repro_torch``:

* ``adamw_update`` over 3 steps: with and without clipping, warmup plus
  cosine with weight decay, f32 and bf16 moments;
* ``reinforce_pp``, ``grpo``, ``gae``, ``whiten``;
* ``token_logprobs``, ``ppo_clip_loss``, ``total_loss`` and the gradient
  of the loss with respect to the logits;
* ``entries_to_batch``: arrays equal exactly, ``info`` equal, the skip
  warning and the all-skipped ``ValueError``;
* one and three ``RLTrainer.update`` steps of the tiny tied model (vocab
  61, d_model 64, 2 layers, f32) on the reference's converted weights:
  loss, every metric, ``grad_norm`` and every parameter leaf (the tied
  embedding collects the gradient of the lookup and of the head);
* checkpoints: written by either package, restored by the other.

Tolerances, each for f32 and stated where used:
* ``TOL`` (rtol 1e-6, atol 1e-7): both sides run the same ops one by one
  and only a reduction's sum order differs (``torch.sum``/``mean`` and
  XLA's can differ in the last bit);
* ``ADV_TOL`` (rtol 1e-6, atol 1e-6): advantages, where that last bit of
  a batch or group mean is divided by a standard deviation of about 0.2
  after ``r - mu`` cancels;
* ``STEP_TOL`` (rtol 1e-4, atol 1e-6): metrics and gradients of the
  model, where the reference's loss is jitted and XLA fuses and reorders
  the f32 sums of the forward and the backward;
* ``PARAM_TOL`` (rtol 1e-4, atol 0.1 lr): parameters after AdamW steps.
  An AdamW step moves a weight by about lr whatever its gradient's size,
  so a gradient component near ``eps`` (1e-8) turns the last bits of
  XLA's reordered sums into a visible share of a step; 0.1 lr still
  fails any update of the wrong sign or size.
"""
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.buffer import BufferEntry as JEntry
from repro.models.model import build_model as jbuild
from repro.rl import advantages as JA
from repro.rl import losses as JL
from repro.rl import trainer as JT
from repro.rl.session import tiny_lm_config as jtiny
from repro.train import checkpoint as JC
from repro.train import optimizer as JO
from repro_torch import convert
from repro_torch.configs.base import tiny_lm_config as ttiny
from repro_torch.core.buffer import BufferEntry as TEntry
from repro_torch.models.model import build_model
from repro_torch.rl import advantages as TA
from repro_torch.rl import losses as TL
from repro_torch.rl import trainer as TT
from repro_torch.train import checkpoint as TC
from repro_torch.train import optimizer as TO

TOL = dict(rtol=1e-6, atol=1e-7)
ADV_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=0.1 * 3e-4)     # 0.1 lr (AdamWConfig())
SHAPES = {"embed": (7, 5), "layers": {"w": (2, 4, 6), "scale": (2, 4)},
          "final_norm": {"scale": (5,)}}


def _tree(shapes, draw):
    return {k: _tree(v, draw) if isinstance(v, dict) else draw(v)
            for k, v in shapes.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _close(want, got, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# -- AdamW ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"grad_clip": 0.0}, {"grad_clip": 0.5},
    {"warmup_steps": 2, "total_steps": 5, "weight_decay": 0.1},
    {"state_dtype": "bf16"}],
    ids=["clip1", "no_clip", "clip_half", "warmup_cosine_wd", "bf16_moments"])
def test_adamw_update_matches_reference_over_3_steps(kw):
    kw = dict(kw)
    bf16 = kw.pop("state_dtype", None) == "bf16"
    jc = JO.AdamWConfig(lr=1e-2, **kw,
                        **({"state_dtype": jnp.bfloat16} if bf16 else {}))
    tc = TO.AdamWConfig(lr=1e-2, **kw,
                        **({"state_dtype": torch.bfloat16} if bf16 else {}))
    rng = np.random.RandomState(0)
    p = _tree(SHAPES, lambda s: rng.randn(*s).astype(np.float32))
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.tensor, p)
    js, ts = JO.init_opt_state(jp, jc), TO.init_opt_state(tp, tc)
    for _ in range(3):
        g = _tree(SHAPES, lambda s: (3 * rng.randn(*s)).astype(np.float32))
        jp, js, jm = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jc)
        tp2, ts, tm = TO.adamw_update(tp, jax.tree.map(torch.tensor, g), ts,
                                      tc)
        assert tp2 is tp                     # written in place
        assert int(ts.step) == int(js.step)
        for k in ("grad_norm", "lr"):
            _close(jm[k], tm[k], **TOL)
        for a, b in zip(jax.tree.leaves(jp), TO.tree_leaves(tp)):
            _close(a, b, **TOL)
        for a, b in zip(jax.tree.leaves((js.m, js.v)),
                        TO.tree_leaves([ts.m, ts.v])):
            assert b.dtype == (torch.bfloat16 if bf16 else torch.float32)
            _close(a, b, **TOL)


def test_adamw_update_keeps_bf16_params_bf16():
    """bf16 parameters: the new value is computed in f32 and cast back,
    as the reference does; both round the same f32 value."""
    rng = np.random.RandomState(1)
    p = _tree(SHAPES, lambda s: rng.randn(*s).astype(np.float32))
    g = _tree(SHAPES, lambda s: rng.randn(*s).astype(np.float32))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tp = jax.tree.map(lambda a: torch.tensor(a).bfloat16(), p)
    jc, tc = JO.AdamWConfig(lr=1e-2), TO.AdamWConfig(lr=1e-2)
    jp, _, _ = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                               JO.init_opt_state(jp, jc), jc)
    TO.adamw_update(tp, jax.tree.map(torch.tensor, g),
                    TO.init_opt_state(tp, tc), tc)
    for a, b in zip(jax.tree.leaves(jp), TO.tree_leaves(tp)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(b), _np(a))


# -- advantages ------------------------------------------------------------------

def _adv_inputs(seed=0, B=6, S=9):
    rng = np.random.RandomState(seed)
    rewards = rng.rand(B).astype(np.float32) * 2
    mask = (rng.rand(B, S) > 0.3).astype(np.float32)
    return rng, rewards, mask


def test_reinforce_pp_grpo_whiten_match_reference():
    rng, rewards, mask = _adv_inputs()
    gids = np.array([0, 0, 1, 1, 1, 2], np.int32)
    T = torch.tensor
    _close(JA.reinforce_pp(rewards, mask),
           TA.reinforce_pp(T(rewards), T(mask)), **ADV_TOL)
    _close(JA.grpo(rewards, gids, mask, 3),
           TA.grpo(T(rewards), T(gids), T(mask), 3), **ADV_TOL)
    adv = rng.randn(*mask.shape).astype(np.float32)
    _close(JA.whiten(adv, mask), TA.whiten(T(adv), T(mask)), **TOL)


@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.9, 0.5)])
def test_gae_matches_reference(gamma, lam):
    rng, _, mask = _adv_inputs(seed=2)
    r = rng.randn(*mask.shape).astype(np.float32)
    v = rng.randn(mask.shape[0], mask.shape[1] + 1).astype(np.float32)
    T = torch.tensor
    _close(JA.gae(r, v, mask, gamma, lam),
           TA.gae(T(r), T(v), T(mask), gamma, lam), **TOL)


# -- losses ----------------------------------------------------------------------

def _loss_inputs(seed=3, B=3, S=7, V=11):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(B, S, V)).astype(np.float32)
    batch = {
        "tokens": rng.randint(0, V, (B, S)).astype(np.int32),
        "loss_mask": (rng.rand(B, S) > 0.4).astype(np.float32),
        "advantages": rng.randn(B, S).astype(np.float32),
        "old_logprobs": (-rng.rand(B, S) * 4).astype(np.float32),
    }
    return logits, batch


def test_token_logprobs_and_ppo_clip_loss_match_reference():
    logits, b = _loss_inputs()
    T = torch.tensor
    jlp = JL.token_logprobs(logits, b["tokens"])
    tlp = TL.token_logprobs(T(logits), T(b["tokens"]))
    _close(jlp, tlp, **TOL)
    cfg_j, cfg_t = JL.LossConfig(), TL.LossConfig()
    jl, jm = JL.ppo_clip_loss(jlp, b["old_logprobs"], b["advantages"],
                              b["loss_mask"], cfg_j)
    tl, tm = TL.ppo_clip_loss(tlp, T(b["old_logprobs"]), T(b["advantages"]),
                              T(b["loss_mask"]), cfg_t)
    _close(jl, tl, **TOL)
    assert set(jm) == set(tm)
    for k in jm:
        _close(jm[k], tm[k], **TOL)
    _close(JL.value_loss(logits[..., 0], logits[..., 1], b["loss_mask"]),
           TL.value_loss(T(logits[..., 0]), T(logits[..., 1]),
                         T(b["loss_mask"])), **TOL)


@pytest.mark.parametrize("entropy_coef", [0.0, 0.01])
def test_total_loss_and_logit_gradient_match_reference(entropy_coef):
    logits, b = _loss_inputs(seed=4)
    cfg_j = JL.LossConfig(entropy_coef=entropy_coef)
    cfg_t = TL.LossConfig(entropy_coef=entropy_coef)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    aux = {"load_balance": 0.0, "router_z": 0.0}

    def jloss(lg):
        return JL.total_loss(lg, aux, jb, cfg_j)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    tlg = torch.tensor(logits, requires_grad=True)
    tl, tm = TL.total_loss(tlg, aux, {k: torch.tensor(v)
                                      for k, v in b.items()}, cfg_t)
    (tg,) = torch.autograd.grad(tl, tlg)
    _close(jl, tl, **TOL)
    assert set(jm) == set(tm)
    for k in jm:
        _close(jm[k], tm[k], **TOL)
    _close(jg, tg, **TOL)


# -- entries_to_batch ------------------------------------------------------------

def _entries(Entry, seed=0, n=6, vocab=61, prompt_len=(3, 12),
             gen_len=(1, 20), groups=3, versions=(0, 1, 2)):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = int(rng.randint(*gen_len))
        out.append(Entry(
            uid=100 + i,
            prompt=rng.randint(1, vocab, rng.randint(*prompt_len)).tolist(),
            meta=types.SimpleNamespace(prompt_id=i % groups),
            generated=rng.randint(1, vocab, g).tolist(),
            logprobs=(-4 * rng.rand(g)).tolist(),
            versions=rng.choice(versions, g).tolist()))
    return out


def _reward(toks, meta):
    return (sum(toks) % 7) / 3.0


@pytest.mark.parametrize("kind", ["reinforce_pp", "grpo"])
@pytest.mark.parametrize("max_len", [64, 20])
def test_entries_to_batch_matches_reference(kind, max_len):
    kw = dict(current_version=3)
    jb, jinfo = JT.entries_to_batch(_entries(JEntry), _reward, 0, max_len,
                                    kind, **kw)
    tb, tinfo = TT.entries_to_batch(_entries(TEntry), _reward, 0, max_len,
                                    kind, device="cpu", **kw)
    assert set(jb) == set(tb)
    for k in jb:
        want = np.array(jb[k])
        assert tb[k].dtype == torch.from_numpy(want).dtype, k
        if k == "advantages":
            _close(want, tb[k], **ADV_TOL)
        else:
            np.testing.assert_array_equal(tb[k].numpy(), want, err_msg=k)
    assert tinfo == jinfo


def test_entries_to_batch_skips_and_raises_like_reference():
    kw = dict(prompt_len=(8, 14), gen_len=(2, 5))
    results = []
    for mod, Entry, extra in ((JT, JEntry, {}), (TT, TEntry,
                                                 {"device": "cpu"})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            _, info = mod.entries_to_batch(_entries(Entry, **kw), _reward,
                                           0, 10, **extra)
        msgs = [str(x.message) for x in w
                if "entries_to_batch" in str(x.message)]
        with pytest.raises(ValueError) as err:
            mod.entries_to_batch(_entries(Entry, **kw), _reward, 0, 5,
                                 **extra)
        results.append((info, msgs, str(err.value)))
    assert results[0] == results[1]
    assert results[1][0]["entries_skipped"] > 0 and results[1][1]


# -- train steps -----------------------------------------------------------------

VOCAB = 61


def _tiny_models():
    jm = jbuild(jtiny(VOCAB, 64, 2))
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = build_model(ttiny(VOCAB, 64, 2), device="cpu")
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("kind", ["reinforce_pp", "grpo"])
def test_train_steps_match_reference(steps, kind):
    """RLTrainer.update on both sides (jitted step against autograd +
    in-place AdamW): every metric within ``STEP_TOL``, every parameter
    leaf within ``PARAM_TOL``; the engine-facing ``params()`` stays the
    same tensors, none of which requires grad."""
    jm, jp, tm, tp = _tiny_models()
    kw = dict(pad_id=0, max_len=64, advantage_kind=kind,
              opt_cfg=None)
    jt = JT.RLTrainer(jm, jp, _reward, **kw)
    tt = TT.RLTrainer(tm, tp, _reward, **kw)
    ids = [id(t) for t in TO.tree_leaves(tt.params())]
    for s in range(steps):
        jrec = jt.update(_entries(JEntry, seed=s, vocab=VOCAB), s)
        trec = tt.update(_entries(TEntry, seed=s, vocab=VOCAB), s)
        assert set(jrec) == set(trec)
        for k in jrec:
            np.testing.assert_allclose(trec[k], jrec[k], err_msg=k,
                                       **STEP_TOL)
        assert trec["grad_norm"] > 0
    assert [id(t) for t in TO.tree_leaves(tt.params())] == ids
    assert not any(t.requires_grad for t in TO.tree_leaves(tt.params()))
    for a, b in zip(jax.tree.leaves(jt.params()),
                    TO.tree_leaves(tt.params())):
        _close(a, b, **PARAM_TOL)


def test_tied_embedding_gradient_matches_reference():
    """d loss / d embed of the tied model collects the lookup and the
    head; against ``jax.grad`` of the same loss."""
    jm, jp, tm, tp = _tiny_models()
    jb, _ = JT.entries_to_batch(_entries(JEntry, vocab=VOCAB), _reward, 0,
                                64)
    tb, _ = TT.entries_to_batch(_entries(TEntry, vocab=VOCAB), _reward, 0,
                                64, device="cpu")
    cfg = JL.LossConfig()

    def jloss(p):
        logits, aux = jm.forward(p, jb)
        return JL.total_loss(logits, aux, jb, cfg)[0]
    jg = jax.jit(jax.grad(jloss))(jp)

    def tloss(p, batch):
        logits, aux = tm.forward(p, batch)
        return TL.total_loss(logits, aux, batch, TL.LossConfig())
    _, tg = TT.value_and_grad(tloss, tp, tb)
    assert len(tg) == len(jax.tree.leaves(jg))
    for a, b in zip(jax.tree.leaves(jg), tg):
        _close(a, b, **STEP_TOL)


# -- checkpoints -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_round_trip_between_packages(tmp_path, dtype, writer):
    """Params and AdamW state written by one package come back bit for
    bit from the other (bf16 through f32, exactly)."""
    rng = np.random.RandomState(5)
    p = _tree(SHAPES, lambda s: rng.randn(*s).astype(np.float32))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    tp = jax.tree.map(lambda a: torch.tensor(a).to(tdt), p)
    jc, tc = JO.AdamWConfig(), TO.AdamWConfig()
    g = _tree(SHAPES, lambda s: rng.randn(*s).astype(np.float32))
    jp, js, _ = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                JO.init_opt_state(jp, jc), jc)
    tp, ts, _ = TO.adamw_update(tp, jax.tree.map(torch.tensor, g),
                                TO.init_opt_state(tp, tc), tc)
    path = str(tmp_path / "ck" / "state")
    if writer == "reference":
        JC.save(path, jp, js, meta={"step": 1})
        rp, rs = TC.restore(path, TO.tree_map(torch.zeros_like, tp),
                            TO.OptState(torch.zeros_like(ts.step),
                                        TO.tree_map(torch.zeros_like, ts.m),
                                        TO.tree_map(torch.zeros_like, ts.v)))
        want_p, want_s = jp, js
        got = TO.tree_leaves([rp, [rs.step, rs.m, rs.v]])
    else:
        TC.save(path, tp, ts, meta={"step": 1})
        rp, rs = JC.restore(path, jax.tree.map(jnp.zeros_like, jp),
                            jax.tree.map(jnp.zeros_like, js))
        want_p, want_s = tp, ts
        got = jax.tree.leaves((rp, rs))
    want = (jax.tree.leaves((want_p, want_s)) if writer == "reference"
            else TO.tree_leaves([want_p, [want_s.step, want_s.m, want_s.v]]))
    assert len(got) == len(want) == 3 * len(TO.tree_leaves(tp)) + 1
    for a, b in zip(want, got):
        assert str(_np(a).dtype) == str(_np(b).dtype)
        np.testing.assert_array_equal(_np(b), _np(a))
