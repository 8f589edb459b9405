"""The placed serve steps of the dense family's local/global pattern and of
``decode_2d`` on ``DeviceMesh``es of gloo ranks, against the reference's
jitted serve steps under its shardings on forced CPU meshes of the same
shapes (``test_torch_placement.py``'s two sides and harness, part
``serve``; the cases are ``placement_cases.PLACED_SERVE_CASES``).

* Gemma2's decode_32k plan (slots over ``data``, the ring's 256 rows and
  the 512 global rows over ``model``) on (2, 2) and (1, 4), and its
  long_500k plan (one slot, both caches' rows over ``("data", "model")``)
  on (2, 2), (1, 4) and (4, 1): each rank writes the new row where it
  falls in its block, attends its block's live rows through the dense
  decode with its lse, and the blocks are combined;
* Qwen1.5's (``qkv_bias``) and Nemotron's (``relu2``, ungated) decode_32k
  plans under ``decode_2d`` on (2, 2), (1, 4) and (4, 1): activations
  hold every slot with their d split over ``data``, no weight gathered.

Each case runs 4 steps over a random cache from the same weights (the
reference's ``init_params`` at ``NARROW`` widths, carried over with
``convert``): tokens equal, log-probs within ``CACHE_TOL``, and every
rank's cache blocks within ``CACHE_TOL`` of the reference's
``addressable_shards`` at the rank's mesh coordinates; every decode call
over a split cache asks for the lse; the step's ``in_shardings``/``out_shardings`` equal the
reference's spec trees.  The serve steps of the families not placed yet
raise on a ``DeviceMesh``, naming the family.  The dense decode's lse at Gemma2's head
(D 256, G 2) under its softcap 50 is that of the capped scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from placement_cases import (ARCHS, B, NARROW, PLACED_SERVE_CASES,
                             REFUSED_SERVE,
                             SERVE_STEPS, SHAPE_BATCH, flat, narrow,
                             serve_inputs)
from repro.configs import base as JB
from repro.models import model as JM
from repro_torch.kernels import ops
from test_torch_launch_steps import CACHE_TOL
from test_torch_placement import load, run_sides

KEYS = sorted({c[1] for c in PLACED_SERVE_CASES})
NAMES = [c[0] for c in PLACED_SERVE_CASES]


@pytest.fixture(scope="module")
def serve(tmp_path_factory):
    d = tmp_path_factory.mktemp("placement_serve")
    inputs = {}
    for key in KEYS:
        cfg = narrow(JB.get_smoke_config(ARCHS[key][0]).replace(
            param_dtype=jnp.float32, compute_dtype=jnp.float32), key)
        params = JM.build_model(cfg).init_params(jax.random.PRNGKey(0))
        inputs.update({f"params_{key}/{k}": np.asarray(v)
                       for k, v in flat(params).items()})
    np.savez(d / "inputs.npz", **inputs)
    run_sides(d, "serve", [4])
    return load(d, "serve", [4])


def case(name):
    return next(c for c in PLACED_SERVE_CASES if c[0] == name)


def lse_asked(name):
    """Per layer of a step: whether its decode asks for the lse (its
    cache's rows or slots split on the ranks)."""
    _, key, shape_name, _ = case(name)
    W = ARCHS[key][1].get("sliding_window", 16)
    whole_ring = (key.startswith("gemma2") and shape_name == "long_500k"
                  and W % 256 != 0)
    return [not (whole_ring and i % 2 == 0)
            for i in range(NARROW["num_layers"])]


@pytest.mark.parametrize("name", NAMES)
def test_placed_serve_matches_reference(serve, name):
    ref_res, port = serve
    want, ranks = ref_res[name], port[name]
    assert len(ranks) == 4
    for r in ranks:
        for i in range(SERVE_STEPS):
            np.testing.assert_array_equal(r[f"token_{i}"], want[f"token_{i}"])
            np.testing.assert_allclose(r[f"logprob_{i}"],
                                       want[f"logprob_{i}"], **CACHE_TOL)
        assert sorted(r["cache_blocks"]) == sorted(want["cache_blocks"])
        for k, block in r["cache_blocks"].items():
            shard = want["cache_blocks"][k][r["coords"]]
            assert block.shape == shard.shape, (k, r["coords"])
            np.testing.assert_allclose(block, shard, err_msg=k, **CACHE_TOL)
        # every attention layer of every step through the dense decode's
        # wrapper, with its lse where its cache's rows are split (the
        # blocks are combined from it); a ring every rank holds whole
        # (long_500k's 16-row ring, its local layers the even ones) is
        # attended as one card's, without
        assert r["decode_calls"] == lse_asked(name) * SERVE_STEPS


@pytest.mark.parametrize("name", NAMES)
def test_placed_serve_shardings_match_reference(serve, name):
    ref_res, port = serve
    want = ref_res[name]
    for r in port[name]:
        for which in ("in_shardings", "out_shardings"):
            assert r[which] == want[which], which


@pytest.mark.parametrize("name", NAMES)
def test_placed_serve_splits_where_the_specs_do(serve, name):
    """The cases place something: the ring's and the global rows split
    over the rows' axes (the ring's 256 rows over ``model`` at
    decode_32k, over ``("data", "model")`` at long_500k), the slots over
    ``data`` at decode_32k; under ``decode_2d`` the weights keep their
    d block over ``data`` and their heads and vocabulary over ``model``
    (nothing gathered, as the reference's 2D decode)."""
    _, port = serve
    _, key, shape_name, mesh = case(name)
    nd, nm = mesh
    rows = SHAPE_BATCH.get(shape_name, B)
    r = port[name][0]
    blocks = {k: v.shape for k, v in r["cache_blocks"].items()}
    d, H, V = NARROW["d_model"], NARROW["num_heads"], NARROW["vocab_size"]
    if key.startswith("gemma2"):
        W = ARCHS[key][1].get("sliding_window", 16)
        if shape_name == "long_500k":
            assert blocks["k_global"][1:3] == (1, 512 // (nd * nm))
            # a ring 16 x 16 does not divide stays whole
            assert blocks["k_local"][1:3] == (
                1, W // (nd * nm) if W % 256 == 0 else W)
        else:
            assert blocks["k_global"][1:3] == (rows // nd, 512 // nm)
            assert blocks["k_local"][1:3] == (rows // nd, W // nm)
        return
    assert blocks["k"][1:3] == (rows // nd, 512 // nm)
    shapes = r["local_shapes"]
    assert shapes["layers/attn/wq"][1:] == (d // nd, H // nm,
                                            NARROW["head_dim"])
    assert shapes["layers/attn/wo"][1:] == (H // nm, NARROW["head_dim"],
                                            d // nd)
    assert shapes["lm_head"] == (d // nd, V // nm)
    assert shapes["embed"] == (V, d // nm)


def test_serve_inputs_cross_the_window():
    """Slot lengths on both sides of the 256-row ring, one wrapping during
    the steps, one slot with rows in only part of the blocks."""
    lens = serve_inputs(B)["kv_len"]
    assert (lens < 256).any() and (lens > 256).any()
    assert lens[1] < 256 <= lens[1] + SERVE_STEPS - 1 and lens[0] == 5
    assert 256 < serve_inputs(1)["kv_len"][0] < 512 - 128


@pytest.mark.parametrize("family", sorted(REFUSED_SERVE))
def test_unplaced_family_serve_step_refused_on_a_device_mesh(serve, family):
    """The serve steps of the families not placed yet (vlm, audio,
    hybrid, ssm) carry no placements on a ``DeviceMesh`` and raise when
    called, naming the family."""
    _, port = serve
    for r in port["refused"]:
        placed, error = r[family]
        assert not placed
        assert error is not None and family in error, error


@pytest.mark.parametrize("D,G,cap,scale", [(256, 2, 50.0, 40.0),
                                           (256, 2, 50.0, 1.0),
                                           (192, 12, 0.0, 1.0)])
def test_decode_lse_is_the_capped_scores(D, G, cap, scale):
    """The dense decode's lse (its plain version on the CPU) at Gemma2's
    head under its attention softcap (q scaled so that the cap bites) and
    at Nemotron's (192, 12), against a float64 logsumexp of the capped
    scores; -inf and zeros for a slot with no live row."""
    rng = np.random.RandomState(1)
    Bq, S, Kh = 4, 48, 2
    H = Kh * G
    q = (scale * rng.randn(Bq, H, D)).astype(np.float32)
    k = rng.randn(Bq, S, Kh, D).astype(np.float32)
    v = rng.randn(Bq, S, Kh, D).astype(np.float32)
    kv = np.array([48, 0, 1, 30], np.int32)
    out, lse = ops.ragged_decode_attention(
        *(torch.from_numpy(x) for x in (q, k, v, kv)), softcap=cap,
        return_lse=True)
    s = np.einsum("bkgd,bskd->bkgs", q.reshape(Bq, Kh, G, D)
                  .astype(np.float64) / np.sqrt(D), k.astype(np.float64))
    if cap:
        s = np.tanh(s / cap) * cap
        assert np.abs(s).max() > 0.5 * cap or scale == 1.0
    for b in range(Bq):
        if not kv[b]:
            assert np.isneginf(lse[b].numpy()).all() and not out[b].any()
            continue
        x = s[b][..., :kv[b]]
        m = x.max(-1, keepdims=True)
        want = (m[..., 0] + np.log(np.exp(x - m).sum(-1))).reshape(H)
        np.testing.assert_allclose(lse[b].numpy(), want, atol=2e-5 * scale,
                                   rtol=1e-6)
