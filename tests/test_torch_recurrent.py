"""The left-padded recurrent families on the port, against the reference,
on the CPU in f32: Zamba2-1.2B (Mamba2 SSD layers and a shared attention
block; ``hybrid``) and xLSTM-125M (mLSTM and sLSTM blocks; ``ssm``), each
at its ``smoke_config()``, and Zamba2's smoke config with a third layer
(``zamba2_tail``: one group of two Mamba2 layers, the shared block, then
a tail layer, the layout of the published 38 = 6 x 6 + 2).

Weights come from the reference's ``init_params`` and are carried over
with ``repro_torch.convert``; inputs are numpy arrays from a seed fed to
both packages.  Tolerances are ``tests/test_torch_families.py``'s: atol
= rtol = 1e-4 (``ATOL``, f32; only the order of sums differs between the
frameworks); the recurrent cores alone are held to the same ATOL.  The
engines and the trainer: ``test_torch_recurrent_engines.py``.

Where the reference is wrong the port is held to its own forward: the
reference's left-padded prefill lets the pads into the states once the
conv biases (Zamba2), the input layernorms' biases or the sLSTM gate
biases (xLSTM) are not zero, which RL updates make them.  The port masks
the pads' contributions, so its left-padded prefill equals its unpadded
forward within ``OWN_FORWARD_TOL`` at any width and any biases
(``test_left_pad_fault_*``); at zero biases both packages agree.
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
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import xlstm as JX
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.model import build_model, supports_paging
from repro_torch.rollout.engine import SlotEngine
import left_pad_fault as LPF
from test_torch_families import ATOL, OWN_FORWARD_TOL, _close_tree, _t

ZAMBA, XLSTM = LPF.ZAMBA, LPF.XLSTM
ARCHS = [ZAMBA, XLSTM]
MODELS = ["zamba2", "zamba2_tail", "xlstm"]
_cfgs, _models, _left = LPF.cfgs, LPF.models, LPF.left_padded


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), _np(want),
                               **(tol or ATOL))


# -- configs, init, conversion ---------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_apart_from_dtype(arch):
    for j, t in ((jget_config(arch), get_config(arch)),
                 (jget_smoke(arch), get_smoke_config(arch))):
        for f in dataclasses.fields(j):
            if f.name not in ("param_dtype", "compute_dtype", "attn", "ssm"):
                assert getattr(j, f.name) == getattr(t, f.name), f.name
        assert dataclasses.asdict(j.attn) == dataclasses.asdict(t.attn)
        assert (j.ssm is None) == (t.ssm is None)
        if j.ssm is not None:
            assert dataclasses.asdict(j.ssm) == dataclasses.asdict(t.ssm)
        assert t.param_dtype == t.compute_dtype == torch.bfloat16
    aliases = [a for a, m in JALIASES.items() if m == arch]
    assert aliases and all(get_config(a) == get_config(arch) for a in aliases)


@pytest.mark.parametrize("name", MODELS)
def test_init_tree_keys_shapes_and_dtypes_match_reference(name):
    """Key for key, shape for shape, the f32 leaves (A_log, dt_bias, D,
    b_if, b_gates, R) f32 and every other leaf in the parameter dtype, in
    bf16 as the published configs have it; the random leaves' spreads
    within 10%."""
    jcfg, tcfg = _cfgs(name)
    jcfg = jcfg.replace(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    tcfg = tcfg.replace(param_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16)
    jp = jax.tree.map(np.asarray, jbuild(jcfg).init_params(
        jax.random.PRNGKey(0)))
    tp = build_model(tcfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    f32_leaves = {"A_log", "dt_bias", "D", "b_if", "b_gates", "R"}

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
                continue
            assert tuple(a[k].shape) == tuple(b[k].shape), path + k
            want = torch.float32 if k in f32_leaves else torch.bfloat16
            assert b[k].dtype == want and a[k].dtype.itemsize == \
                b[k].element_size(), (path + k, a[k].dtype, b[k].dtype)
            sa, sb = float(np.std(a[k].astype(np.float32))), \
                float(b[k].float().std())
            assert abs(sa - sb) <= 0.1 * max(sa, 1e-6), (path + k, sa, sb)
    walk(jp, tp)


@pytest.mark.parametrize("name", MODELS)
def test_convert_round_trip_keeps_each_leafs_dtype(name):
    """bf16 leaves round-trip through f32 exactly and come back bf16; the
    reference's f32 leaves stay f32."""
    jcfg, _ = _cfgs(name)
    jcfg = jcfg.replace(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, jbuild(jcfg).init_params(
        jax.random.PRNGKey(2)))
    tp = convert.from_jax_params(jp, device="cpu")
    back = convert.to_numpy(tp)
    for a, b, c in zip(jax.tree.leaves(jp), jax.tree.leaves(tp),
                       jax.tree.leaves(back)):
        assert b.dtype == (torch.bfloat16 if a.dtype.name == "bfloat16"
                           else torch.float32)
        np.testing.assert_array_equal(c, a.astype(np.float32))


# -- the recurrent cores -----------------------------------------------------------

def _ssd_inputs(seed, T, B=2, H=4, P=8, G=2, N=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, H, P).astype(np.float32),
            (-np.abs(rng.randn(B, T, H)) * 0.3).astype(np.float32),
            rng.randn(B, T, G, N).astype(np.float32),
            rng.randn(B, T, G, N).astype(np.float32),
            rng.randn(B, H, N, P).astype(np.float32))


@pytest.mark.parametrize("T,chunk,with_state", [(16, 8, False), (21, 8, True),
                                                (5, 16, True)])
def test_ssd_chunked_and_ref_match_reference(T, chunk, with_state):
    """T a multiple of the chunk, T not (the tail padded), T below one
    chunk; with and without an initial state."""
    x, a, b, c, s0 = _ssd_inputs(T, T)
    init = s0 if with_state else None
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (x, a, b, c)), chunk,
                            None if init is None else jnp.asarray(init))
    ty, ts = S.ssd_chunked(*map(_t, (x, a, b, c)), chunk,
                           None if init is None else _t(init))
    _close(ty, jy)
    _close(ts, js)
    ry, rs = S.ssd_ref(*map(_t, (x, a, b, c)),
                       None if init is None else _t(init))
    _close(ry, jy)
    _close(rs, js)


def test_ssd_decode_continues_the_chunked_state():
    """Eight steps chunked from a random state, then one decode step:
    the step equals the reference's ``ssd_decode`` from the same state
    and its sequential oracle's ninth step."""
    x, a, b, c, s0 = _ssd_inputs(3, 9)
    _, state = S.ssd_chunked(*map(_t, (x[:, :8], a[:, :8], b[:, :8],
                                       c[:, :8])), 4, _t(s0))
    last = (x[:, 8], a[:, 8], b[:, 8], c[:, 8])
    jy1, js1 = JS.ssd_decode(*map(jnp.asarray, last),
                             jnp.asarray(state.numpy()))
    y, state = S.ssd_decode(*map(_t, last), state)
    _close(y, jy1)
    _close(state, js1)
    jy, js = JS.ssd_ref(*map(jnp.asarray, (x, a, b, c)), jnp.asarray(s0))
    _close(y, jy[:, 8])
    _close(state, js)


def _mlstm_inputs(seed, T, B=2, H=2, D=8):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    i_pre = (rng.randn(B, T, H) * 2).astype(np.float32)
    f_pre = (rng.randn(B, T, H) + 2).astype(np.float32)
    C0 = rng.randn(B, H, D, D).astype(np.float32)
    n0 = rng.randn(B, H, D).astype(np.float32)
    return (q, k, v, i_pre, f_pre), (C0, n0)


@pytest.mark.parametrize("T,chunk,with_state", [(16, 8, False), (12, 4, True),
                                                (7, 7, True)])
def test_mlstm_chunked_ref_and_decode_match_reference(T, chunk, with_state):
    """Chunked and sequential mLSTM, and one decode step after them, with
    and without an initial state."""
    args, s0 = _mlstm_inputs(T, T + 1)
    init = s0 if with_state else None
    ja = [jnp.asarray(a[:, :T]) for a in args]
    ta = [_t(a[:, :T]) for a in args]
    jh, (jC, jn) = JX.mlstm_chunked(*ja, chunk, None if init is None else
                                    tuple(map(jnp.asarray, init)))
    th, (tC, tn) = X.mlstm_chunked(*ta, chunk, None if init is None else
                                   tuple(map(_t, init)))
    _close(th, jh)
    _close(tC, jC)
    _close(tn, jn)
    rh, (rC, rn) = X.mlstm_ref(*ta, None if init is None else
                               tuple(map(_t, init)))
    _close(rh, jh)
    _close(rC, jC)
    last = [a[:, T] for a in args]
    jd, (jC1, jn1) = JX.mlstm_decode(*map(jnp.asarray, last), (jC, jn))
    td, (tC1, tn1) = X.mlstm_decode(*map(_t, last), (tC, tn))
    _close(td, jd)
    _close(tC1, jC1)
    _close(tn1, jn1)


@pytest.mark.parametrize("T", [1, 9])
def test_slstm_scan_matches_reference(T):
    """The sLSTM loop from the initial state and from a random one."""
    rng = np.random.RandomState(T)
    B, H, Dh = 2, 2, 8
    xg = rng.randn(B, T, 4, H, Dh).astype(np.float32)
    R = (rng.randn(4, H, Dh, Dh) / np.sqrt(Dh)).astype(np.float32)
    rand = tuple(rng.randn(B, H, Dh).astype(np.float32) for _ in range(4))
    for state in (None, rand):
        js = (JX.slstm_init_state(B, H, Dh) if state is None
              else tuple(map(jnp.asarray, state)))
        ts = (X.slstm_init_state(B, H, Dh, "cpu") if state is None
              else tuple(map(_t, state)))
        jh, jst = JX.slstm_scan(jnp.asarray(xg), jnp.asarray(R), js)
        th, tst = X.slstm_scan(_t(xg), _t(R), ts)
        _close(th, jh)
        for a, b in zip(tst, jst):
            _close(a, b)


# -- the models -------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_forward_logits_match_reference(name):
    jm, jp, tm, tp = _models(name)
    toks = np.random.RandomState(4).randint(
        0, jm.cfg.vocab_size, size=(2, 37)).astype(np.int32)   # > 2 chunks
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": _t(toks)})
    _close(got, want)
    assert aux == {"load_balance": 0.0, "router_z": 0.0}


@pytest.mark.parametrize("name,width", [
    (name, w) for name in ("zamba2", "xlstm") for w in (10, 16, 32)]
    + [("zamba2_tail", 16)])
def test_left_padded_prefill_matches_reference(name, width):
    """Prompts of 10, 7 and 1 tokens left-padded to ``width``, at zero
    biases: logits and every cache entry equal the reference's."""
    jm, jp, tm, tp = _models(name)
    rng = np.random.RandomState(width)
    prompts = [rng.randint(1, jm.cfg.vocab_size, n).tolist()
               for n in (10, 7, 1)]
    toks, plens = _left(prompts, width)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "prompt_lens": jnp.asarray(plens)},
                        jm.init_cache(3, 40))
    tl, tc = tm.prefill(tp, {"tokens": _t(toks), "prompt_lens": _t(plens)},
                        tm.init_cache(3, 40))
    for b, n in enumerate(plens):      # the pad rows' logits are garbage
        _close(tl[b, width - n:], jl[b, width - n:])
    _close_tree(jc, tc)


@pytest.mark.parametrize("name", ["zamba2_tail", "xlstm"])
def test_decode_steps_with_kv_start_match_reference_and_forward(name):
    """Left-padded prefill at width 16 (prompts of 12 and 5), then 4
    teacher-forced decode steps with ``kv_len`` = width + t and
    ``kv_start`` = the pads: logits and caches equal the reference's, and
    the logits the port's forward on the unpadded sequence."""
    jm, jp, tm, tp = _models(name)
    rng = np.random.RandomState(7)
    seqs = [rng.randint(1, jm.cfg.vocab_size, n + 4).tolist()
            for n in (12, 5)]
    toks, plens = _left([s[:-4] for s in seqs], 16)
    jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                         "prompt_lens": jnp.asarray(plens)},
                    jm.init_cache(2, 24))[1]
    tc = tm.prefill(tp, {"tokens": _t(toks), "prompt_lens": _t(plens)},
                    tm.init_cache(2, 24), return_logits=False)[1]
    kv_start = (16 - plens).astype(np.int32)
    for t in range(4):
        tok = np.asarray([s[len(s) - 4 + t] for s in seqs], np.int32)
        kv_len = np.full(2, 16 + t, np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc,
                                jnp.asarray(kv_len),
                                kv_start=jnp.asarray(kv_start))
        tl, tc = tm.decode_step(tp, _t(tok), tc, _t(kv_len),
                                kv_start=_t(kv_start))
        _close(tl, jl)
        _close_tree(jc, tc)
        for b, s in enumerate(seqs):
            n = len(s) - 4 + t + 1
            fwd, _ = tm.forward(tp, {"tokens": _t(np.asarray([s[:n]]))})
            _close(tl[b], fwd[0, -1])


def test_recurrent_families_refuse_paging_and_the_hidden_state():
    for name in ("zamba2", "xlstm"):
        _, _, tm, tp = _models(name)
        assert tm.padding_side == "left" and not supports_paging(tm)
        assert tm.prefill_packed is None and tm.decode_step_paged is None
        with pytest.raises(ValueError):
            SlotEngine(tm, lambda: tp, capacity=2, max_total_len=32,
                       max_gen_len=4, eos_id=-1, paged=True)
        kv = torch.tensor([3], dtype=torch.int32)
        with pytest.raises(ValueError, match="return_hidden"):
            tm.decode_step(tp, kv, tm.init_cache(1, 8), kv,
                           return_hidden=True)


# -- the fault of the reference's left-padded prefill ----------------------------

# (model, biases perturbed, the reference's least gap at widths 16/32)
FAULTS = [(name, which, 0.01 if name == "zamba2" else 0.1)
          for name, which in LPF.CASES]


@pytest.mark.parametrize("name,which,ref_gap", FAULTS)
def test_left_pad_fault_reference_drifts_port_stays_exact(name, which,
                                                          ref_gap):
    """A 10-token prompt prefilled left-padded to widths 10, 16 and 32,
    with the biases named perturbed by 0.3 N(0, 1)
    (``tests/left_pad_fault.py``), its logprobs at every prompt position
    against each package's own forward on the unpadded prompt: the
    reference's are off by more than ``ref_gap`` nats wherever there are
    pads, the port's within ``OWN_FORWARD_TOL`` at every width; and the
    port's states equal its unpadded prefill's (ATOL)."""
    jm, jp, tm, tp = LPF.perturbed(name, which)
    prompt = LPF.prompt(jm.cfg.vocab_size)
    _, solo = tm.prefill(tp, {"tokens": _t(prompt[None].astype(np.int32)),
                              "prompt_lens": _t(np.array([10], np.int32))},
                         tm.init_cache(1, 32), return_logits=False)
    for width in (10, 16, 32):
        j_gap, t_gap, tc = LPF.gaps(jm, jp, tm, tp, prompt, width)
        assert t_gap <= OWN_FORWARD_TOL, (width, t_gap)
        if width > 10:
            assert j_gap > ref_gap, (width, j_gap)
        for key, got in tc.items():
            if key.startswith("attn_"):      # rows move with the pads
                got, want = got[:, :, width - 10:width], solo[key][:, :, :10]
            else:
                want = solo[key]
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       err_msg=key, **ATOL)


def test_left_pad_mask_holds_above_the_full_attention_width():
    """Above ``FULL_ATTN_MAX_SEQ`` the plain flash version attends
    blockwise: with the left-pad mask as segment ids, the valid rows of a
    padded row equal the unpadded rows' attention, where the reference's
    blockwise branch (no mask) lets the zero pad keys into the softmax."""
    rng = np.random.RandomState(5)
    S, pad, H, D = 2100, 40, 2, 16
    q, k, v = (rng.randn(1, S - pad, H, D).astype(np.float32)
               for _ in range(3))

    def padded(a):
        return np.concatenate([np.zeros((1, pad, H, D), np.float32), a], 1)
    seg = np.concatenate([np.zeros((1, pad)), np.ones((1, S - pad))],
                         1).astype(np.int32)
    got = ops.flash_attention(*map(_t, map(padded, (q, k, v))),
                              seg_ids=_t(seg))
    want = L.blockwise_attention(*map(_t, (q, k, v)), causal=True)
    _close(got[:, pad:], want.numpy())
    assert bool(torch.isfinite(got[:, :pad]).all())
    jgot = JL.blockwise_attention(*map(jnp.asarray, map(padded, (q, k, v))),
                                  causal=True)
    assert float(np.abs(_np(jgot)[:, pad:] - want.numpy()).max()) > 1e-3


# -- the plain versions of the kernels ---------------------------------------------

@pytest.mark.parametrize("S,lens,starts", [
    (16, [16, 9, 1, 0], [6, 0, 0, 0]),
    (40, [40, 33, 12, 5], [39, 7, 12, 9]),     # one row; past kv_len: zeros
])
def test_dense_decode_plain_with_kv_start_matches_reference(S, lens, starts):
    """``ragged_decode_attention_ref(kv_start=)`` against the reference's
    ``layers.decode_attention(kv_start=)``: rows [kv_start, kv_len)."""
    rng = np.random.RandomState(S)
    B, H, Kh, D = len(lens), 4, 2, 16
    q = rng.randn(B, H, D).astype(np.float32)
    kc, vc = (rng.randn(B, S, Kh, D).astype(np.float32) for _ in range(2))
    kv, st = np.asarray(lens, np.int32), np.asarray(starts, np.int32)
    want = JL.decode_attention(*map(jnp.asarray, (q, kc, vc, kv)),
                               kv_start=jnp.asarray(st))
    got = ref.ragged_decode_attention_ref(*map(_t, (q, kc, vc, kv)),
                                          kv_start=_t(st))
    _close(got, want)
    via_op = ops.ragged_decode_attention(*map(_t, (q, kc, vc, kv)),
                                         kv_start=_t(st))
    assert torch.equal(via_op, got)
    empty = [b for b in range(B) if starts[b] >= lens[b]]
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("S,pads", [(16, [0, 1, 15]), (33, [32, 0, 5])])
def test_flash_plain_with_left_pad_seg_ids_matches_reference(S, pads):
    """The flash plain version with the left-pad mask as segment ids (pads
    0, tokens 1) against the reference's ``full_attention(seg_q, seg_k)``;
    a row of pads attends its own pad keys and stays finite."""
    rng = np.random.RandomState(S)
    B, H, D = len(pads), 4, 16
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    seg = (np.arange(S)[None] >= np.asarray(pads)[:, None]).astype(np.int32)
    want = JL.full_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                             seg_q=jnp.asarray(seg), seg_k=jnp.asarray(seg))
    got = ops.flash_attention(*map(_t, (q, k, v)), seg_ids=_t(seg))
    _close(got, want)
    assert bool(torch.isfinite(got).all())
