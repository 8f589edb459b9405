"""The port's placed launch steps on ``DeviceMesh``es of gloo ranks
against the reference's jitted steps, with its shardings, on forced CPU
meshes of the same shapes (``test_torch_placement.py``'s two sides and
harness; the cases are in ``placement_cases.py``).

Each rank holds the blocks the specs give it (``plans.place``), runs
the step on them and gathers its results (``plans.gather``).  The
weights are the reference's ``init_params`` at the narrow widths, carried
over with ``convert``.

* train: 3 steps, B 16, S 64: Qwen3 under its ``dp`` plan, Gemma2 and
  Qwen1.5 under ``tp`` with FSDP, the sequence-parallel residual, remat
  and 2 microbatches (Qwen1.5's moments bf16), on (2, 2) and (1, 4)
  (Gemma2 at B 4, which the specs replicate over ``data``, runs with the
  placement cases, ``test_torch_placement.py``):
  loss and grad norm within ``STEP_TOL`` at every step, the gathered
  parameters within ``PARAM_TOL`` after the 3, the replicated leaves the
  same bits on every rank after every step, and each rank's parameter
  and moment blocks of the placed shapes;
* prefill: Qwen3's prefill_32k plan (``tp``), B 16, at Kh 8 (the cache's
  KV heads replicated) and Kh 16 (split over ``model``) on (2, 2): the
  tokens equal, the gathered caches within ``CACHE_TOL``;
* serve: Qwen3's decode_32k plan (``dp``, ``seqshard``), B 16, 4 steps
  on (1, 4) and (2, 2): tokens equal, log-probs and the gathered caches
  within ``CACHE_TOL``; every decode call asks the dense decode for its
  lse (the blocks are combined from it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_cpu  # noqa: F401
from placement_cases import (ARCHS, B, NARROW, PREFILL_CASES, SERVE_CASES,
                             SERVE_STEPS, TRAIN_CASES, TRAIN_STEPS, flat)
from repro.configs import base as JB
from repro.models import model as JM
from test_torch_launch_steps import CACHE_TOL, PARAM_TOL, STEP_TOL
from test_torch_placement import load, run_sides

KEYS = sorted({c[1] for c in TRAIN_CASES + PREFILL_CASES + SERVE_CASES})


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    d = tmp_path_factory.mktemp("placement_steps")
    inputs = {}
    for key in KEYS:
        arch, extra = ARCHS[key]
        cfg = JB.get_smoke_config(arch).replace(
            param_dtype=jnp.float32, compute_dtype=jnp.float32,
            **dict(NARROW, **extra))
        params = JM.build_model(cfg).init_params(jax.random.PRNGKey(0))
        inputs.update({f"params_{key}/{k}": np.asarray(v)
                       for k, v in flat(params).items()})
    np.savez(d / "inputs.npz", **inputs)
    run_sides(d, "steps", [4])
    return load(d, "steps", [4])


@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_train_losses_and_grad_norms_match_reference(steps, name):
    ref_res, port = steps
    want, ranks = ref_res[name], port[name]
    assert len(ranks) == 4
    for i in range(TRAIN_STEPS):
        for k in (f"loss_{i}", f"grad_norm_{i}"):
            assert len({r[k] for r in ranks}) == 1, (k, [r[k] for r in ranks])
            np.testing.assert_allclose(ranks[0][k], want[k], err_msg=k,
                                       **STEP_TOL)


@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_train_parameters_match_reference(steps, name):
    ref_res, port = steps
    want, ranks = ref_res[name], port[name]
    leaves = [k[len("param/"):] for k in want if k.startswith("param/")]
    for r in ranks:
        assert sorted(leaves) == sorted(r["params"])
        for k in leaves:
            np.testing.assert_allclose(r["params"][k], want[f"param/{k}"],
                                       err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_train_replicated_leaves_bit_equal_and_blocks_placed(steps, name):
    _, port = steps
    ranks = port[name]
    _, key, mesh, _, _ = next(c for c in TRAIN_CASES if c[0] == name)
    for r in ranks:
        for i in range(TRAIN_STEPS):
            assert r[f"digest_{i}"] == ranks[0][f"digest_{i}"], (i,
                                                                  r["coords"])
        assert r["moment_shapes"] == r["local_shapes"]
    d, H = NARROW["d_model"], NARROW["num_heads"]
    wq = ranks[0]["local_shapes"]["layers/attn/wq"]
    if key == "qwen3":                      # dp: replicated
        assert wq[-3:] == (d, H, NARROW["head_dim"])
    else:                                   # tp: FSDP over data, heads
        assert wq[-3:] == (d // mesh[0], H // mesh[1], NARROW["head_dim"])


@pytest.mark.parametrize("name", [c[0] for c in PREFILL_CASES])
def test_prefill_matches_reference(steps, name):
    ref_res, port = steps
    want, ranks = ref_res[name], port[name]
    kh = 16 if "kh16" in name else 8
    for r in ranks:
        np.testing.assert_array_equal(r["token"], want["token"])
        for k, v in r["cache"].items():
            np.testing.assert_allclose(v, want[f"cache/{k}"], err_msg=k,
                                       **CACHE_TOL)
        # slots over data (2); KV heads over model (2) where 16 divides
        L_, Bl, S_, Khl, _ = r["cache_local_shapes"]["k"]
        assert Bl == B // 2 and Khl == (kh // 2 if kh == 16 else kh)


@pytest.mark.parametrize("name", [c[0] for c in SERVE_CASES])
def test_serve_matches_reference(steps, name):
    ref_res, port = steps
    want, ranks = ref_res[name], port[name]
    mesh = tuple(int(x) for x in name.split("_m")[1].split("x"))
    for r in ranks:
        for i in range(SERVE_STEPS):
            np.testing.assert_array_equal(r[f"token_{i}"], want[f"token_{i}"])
            np.testing.assert_allclose(r[f"logprob_{i}"],
                                       want[f"logprob_{i}"], **CACHE_TOL)
        for k, v in r["cache"].items():
            np.testing.assert_allclose(v, want[f"cache/{k}"], err_msg=k,
                                       **CACHE_TOL)
        L_, Bl, S_, _, _ = r["cache_local_shapes"]["k"]
        assert (Bl, S_) == (B // mesh[0], 512 // mesh[1])
        # every layer of every step through the wrapper, with the lse
        assert r["decode_calls"] == [True] * (SERVE_STEPS
                                              * NARROW["num_layers"])
