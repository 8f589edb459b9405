"""The port's launch steps against the reference's, on the CPU, for the
dense family (Qwen3-0.6B, Gemma2-2B, Qwen1.5-110B, Nemotron-4-340B) at
their smoke configs in f32.  The same helpers run the MoE family in
``test_torch_launch_moe.py``, the vlm, audio and recurrent families in
``test_torch_launch_families.py``, and Qwen3 with 2 microbatches beside
the launcher's CLI in ``test_torch_launch_cli.py``.

The reference's steps come from ``repro.launch.steps`` on
``make_local_mesh()`` and run under ``jax.jit`` with its shardings; the
port's from ``repro_torch.launch.steps`` on ``device="cpu"``.  Weights are
the reference's ``init_params`` carried over with ``convert``; batches
are numpy arrays from a seed fed to both.  The plan is the reference
launcher's local one (data parallel, no remat), except for the MoE
family, which takes the ``tp`` plan: the local ``dp`` plan puts the batch
over ``model`` and the reference's expert-parallel layer also splits the
sequence there (``DuplicateSpecError``, pinned in ``test_torch_launch_cli.py``).

* train: 3 steps of ``build_train_step`` (B 4, S 64): loss and grad
  norm at every step within ``STEP_TOL`` and every parameter after the 3
  steps within ``PARAM_TOL`` (``tests/test_torch_rl.py``'s, for the same
  reasons: XLA fuses and reorders the f32 sums of the jitted step);
* prefill: ``build_prefill_step`` on prompts of random lengths (Gemma2's
  fill the width: the reference's ring of a shorter prompt holds pad
  rows, a fault of its own that ``tests/test_torch_families.py`` covers):
  tokens equal, every K/V cache leaf within 1e-5 (``CACHE_TOL``), the
  recurrent states within ``STATE_TOL`` (1e-4, the recurrent tests');
* serve: two ``build_serve_step`` steps on the prefill's cache: tokens
  equal, log-probs within 1e-5, caches as the prefill's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from repro.configs import base as JB
from repro.launch import mesh as JMESH
from repro.launch import plans as JP
from repro.launch import steps as JS
from repro.train import optimizer as JO
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import plans as TP
from repro_torch.launch import steps as TS
from repro_torch.train import optimizer as TO

STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=0.1 * 3e-4)     # 0.1 lr (AdamWConfig())
# K/V cache rows and serve log-probs: 1e-5.  Recurrent states (Zamba2's
# SSM and conv states, xLSTM's mLSTM/sLSTM states) carry 64 steps of a
# recurrence whose f32 sums XLA reorders (|C| ~ 10 moves by ~30 ulps): the
# tolerance tests/test_torch_recurrent.py holds them to (atol = rtol =
# 1e-4).
CACHE_TOL = dict(atol=1e-5, rtol=0)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
KV_KEYS = {"k", "v", "k_local", "v_local", "k_global", "v_global", "k_x",
           "v_x", "attn_k", "attn_v"}
B, S = 4, 64
DENSE_ARCHS = ["qwen3_0_6b", "gemma2_2b", "qwen1_5_110b", "nemotron_4_340b"]
_PARAMS = {}


def configs(arch):
    return (JB.get_smoke_config(arch).replace(param_dtype=jnp.float32,
                                              compute_dtype=jnp.float32),
            TB.get_smoke_config(arch).replace(param_dtype=torch.float32,
                                              compute_dtype=torch.float32))


def plans(arch, micro=1):
    kw = dict(strategy="tp" if "moe" in arch else "dp", fsdp=False,
              seq_parallel=False, remat=False, microbatches=micro)
    return JP.Plan(**kw), TP.Plan(**kw)


def shapes(kind, seq=S, batch=B):
    return (JB.ShapeConfig("local", seq, batch, kind),
            TB.ShapeConfig("local", seq, batch, kind))


def params(arch, jmodel):
    """The reference's weights (numpy), built once per arch."""
    if arch not in _PARAMS:
        _PARAMS[arch] = jax.tree.map(
            np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    return _PARAMS[arch]


def both(arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


def stub(tcfg, rng):
    """Random stub-frontend inputs (patch rows, audio frames)."""
    key = {"vlm": "patch_embeds", "audio": "frames"}.get(tcfg.family)
    if key is None:
        return {}
    return {key: (0.5 * rng.randn(B, tcfg.num_stub_positions,
                                  tcfg.d_model)).astype(np.float32)}


def jit(built):
    return jax.jit(built.fn, in_shardings=built.in_shardings,
                   out_shardings=built.out_shardings,
                   donate_argnums=built.donate_argnums)


def close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def close_tree(want, got):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **(CACHE_TOL if k in KV_KEYS
                                                  else STATE_TOL))


def run_train(arch, micro=1, steps=3):
    jcfg, tcfg = configs(arch)
    jplan, tplan = plans(arch, micro)
    jshape, tshape = shapes("train")
    jb = JS.build_train_step(jcfg, jshape, jplan, JMESH.make_local_mesh(),
                             False)
    tb = TS.build_train_step(tcfg, tshape, tplan, TMESH.make_local_mesh(),
                             False, device="cpu")
    assert tb.donate_argnums == jb.donate_argnums
    npp = params(arch, jb.model)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = convert.from_jax_params(npp, device="cpu")
    jo = JO.init_opt_state(jp, JO.AdamWConfig())
    to = TO.init_opt_state(tp, TO.AdamWConfig())
    rng = np.random.RandomState(11)
    arrays = {"tokens": rng.randint(0, tcfg.vocab_size, (B, S))
              .astype(np.int32),
              "loss_mask": (rng.rand(B, S) < 0.8).astype(np.float32),
              "advantages": rng.randn(B, S).astype(np.float32),
              "old_logprobs": (-2.0 + 0.1 * rng.randn(B, S))
              .astype(np.float32), **stub(tcfg, rng)}
    jbatch, tbatch = both(arrays)
    step = jit(jb)
    for i in range(steps):
        jp, jo, jm = step(jp, jo, jbatch)
        tp, to, tm = tb.fn(tp, to, tbatch)
        for k in ("loss", "grad_norm"):
            close(jm[k], tm[k].detach(), **STEP_TOL, err_msg=f"{k} step {i}")
        assert np.isfinite(float(tm["loss"]))
    jleaves = jax.tree.leaves(jp)
    tleaves = TO.tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        close(a, b.detach(), **PARAM_TOL)
    return jm, tm


def run_prefill_and_serve(arch, serve_steps=2):
    jcfg, tcfg = configs(arch)
    jplan, tplan = plans(arch)
    jmesh = JMESH.make_local_mesh()
    jpre = JS.build_prefill_step(jcfg, shapes("prefill")[0], jplan, jmesh,
                                 False)
    tpre = TS.build_prefill_step(tcfg, shapes("prefill")[1], tplan,
                                 TMESH.make_local_mesh(), False,
                                 device="cpu")
    extra = tpre.model.prefill_extra
    assert extra == jpre.model.prefill_extra
    max_len = TS._round_len(S + extra + 8)
    assert max_len == JS._round_len(S + extra + 8)
    npp = params(arch, jpre.model)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = convert.from_jax_params(npp, device="cpu")
    rng = np.random.RandomState(12)
    left = tpre.model.padding_side == "left"
    lens = rng.randint(S // 2, S + 1, size=B).astype(np.int32)
    lens[0] = S
    if tcfg.attn.layer_pattern == "local_global":
        # the reference fills a ring from the padded width's last W
        # columns, so a shorter prompt gets pad rows in its ring; the port
        # fills it from the prompt's own end and is held to its forward
        # there by tests/test_torch_families.py.  Full prompts here.
        lens[:] = S
    arrays = {"tokens": rng.randint(1, tcfg.vocab_size, (B, S))
              .astype(np.int32), "prompt_lens": lens, **stub(tcfg, rng)}
    jbatch, tbatch = both(arrays)
    jtok, jcache = jit(jpre)(jp, jbatch, jpre.model.init_cache(B, max_len))
    ttok, tcache = tpre.fn(tp, tbatch, tpre.model.init_cache(B, max_len))
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    close_tree(jcache, tcache)

    jsrv = JS.build_serve_step(jcfg, shapes("decode")[0], jplan, jmesh,
                               False)
    tsrv = TS.build_serve_step(tcfg, shapes("decode")[1], tplan,
                               TMESH.make_local_mesh(), False, device="cpu")
    jserve = jit(jsrv)
    kv = np.full(B, S, np.int32) if left else lens + extra
    jt, tt = jnp.asarray(jtok), ttok
    for i in range(serve_steps):
        jt, jlp, jcache = jserve(jp, jt, jcache, jnp.asarray(kv))
        tt, tlp, tcache = tsrv.fn(tp, tt, tcache, torch.from_numpy(kv))
        assert tt.dtype == torch.int32 and tlp.dtype == torch.float32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"serve step {i}")
        close(jlp, tlp, **CACHE_TOL)
        close_tree(jcache, tcache)
        kv = kv + 1


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_train_step_matches_reference_over_3_steps(arch):
    run_train(arch)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_serve_steps_match_reference(arch):
    run_prefill_and_serve(arch)


def test_built_specs_are_meta_stand_ins():
    """``in_specs`` are meta tensors with the reference's shapes; the
    train step's moments carry the plan's dtype."""
    jcfg, tcfg = configs("qwen3_0_6b")
    jplan = JP.Plan(opt_dtype=jnp.bfloat16, remat=False)
    tplan = TP.Plan(opt_dtype=torch.bfloat16, remat=False)
    for kind in ("train", "prefill", "decode"):
        jshape, tshape = shapes(kind, seq=128, batch=2)
        jb = JS.build_step(jcfg, jshape, jplan, JMESH.make_local_mesh(),
                           False)
        tb = TS.build_step(tcfg, tshape, tplan, TMESH.make_local_mesh(),
                           False, device="cpu")
        jl = jax.tree.leaves(jb.in_specs)
        tl = TO.tree_leaves(list(tb.in_specs))
        assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
        assert all(x.device.type == "meta" for x in tl)
        assert tb.rules == jb.rules and tb.donate_argnums == jb.donate_argnums
        if kind == "train":
            assert all(x.dtype == torch.bfloat16 for x in
                       TO.tree_leaves([tb.in_specs[1].m, tb.in_specs[1].v]))
