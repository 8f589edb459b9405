"""The MoE family's placed launch steps on ``DeviceMesh``es of gloo ranks,
against the reference's jitted steps under its shardings on forced CPU
meshes of the same shapes (``test_torch_placement.py``'s two sides and
harness, a part ``moe_<key>`` an architecture, both run at once; the
cases are ``placement_cases.MOE_*_CASES``).

Two configs at ``NARROW`` widths, top-2 at cf 1.25 (``MOE_ARCHS``):
Granite-MoE with 6 experts (the specs replicate them over ``model``, 16
not dividing 6, and the expert-parallel layer pads them to 8 on (1, 4))
and Qwen3-MoE with 16 and qk-norm (the experts split over ``model``);
both FSDP over ``data``.  Token ids come from ``MOE_IDS`` so that the
routers crowd a few experts and drop pairs.  Granite's train and
prefill run again at vocabulary 515 (``MOE_WHOLE_VOCAB``), which the
model axis of 2 or 4 does not divide, as Granite's published 49,155: its
head and tied embedding whole on every rank, the logits the whole
vocabulary's.

* placement: every parameter, moment, batch and cache block of the
  train_4k, prefill_32k and decode_32k plans on (2, 2), (1, 4) and
  (4, 1) has the digest of the reference's ``addressable_shards``;
* train: 3 steps (``tp``, FSDP, sequence parallelism, remat, 2
  microbatches, B 16, S 64) on (2, 2) and (1, 4): grad norms within
  ``STEP_TOL``, the loss within ``STEP_TOL`` of the mean of the
  reference's devices' losses (its aux is each device's data shard's,
  ``test_torch_moe_ep_steps.py``), the parameters gathered within
  ``PARAM_TOL``, the replicated leaves the same bits on every rank;
* prefill on (2, 2): tokens equal, caches within ``CACHE_TOL``;
* serve: 4 steps of Granite's decode_32k (``seqshard``: slots over
  ``data``, the cache's rows over ``model``) on (2, 2) and (1, 4) and of
  Qwen3-MoE's (``decode_2d``) on the three meshes: tokens equal,
  log-probs and every rank's cache blocks within ``CACHE_TOL``;
* dispatch: every MoE call's ``idx``/``keep`` exactly the reference's:
  the expert-parallel blocks of train and prefill (as a set over the
  ranks: a rank's microbatch slices are blocks the reference's devices
  take in other microbatches), and the serve steps' whole-batch calls
  assembled from the ranks' rows; the cases drop pairs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_cpu  # noqa: F401
from placement_cases import (ARCHS, MESHES, MOE_ARCHS, MOE_PARTS,
                             MOE_PLACE_CASES, MOE_PREFILL_CASES,
                             MOE_SERVE_CASES,
                             MOE_TRAIN_CASES, NARROW, SERVE_STEPS,
                             TRAIN_STEPS, digest, flat, narrow)
from repro.configs import base as JB
from repro.models import model as JM
from test_torch_launch_steps import CACHE_TOL, PARAM_TOL, STEP_TOL
from test_torch_placement import load, run_sides

TRAIN = {c[0]: c for c in MOE_TRAIN_CASES}
PREFILL = {c[0]: c for c in MOE_PREFILL_CASES}
SERVE = {c[0]: c for c in MOE_SERVE_CASES}


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    d = tmp_path_factory.mktemp("placement_moe")
    inputs = {}
    for key in MOE_PARTS:
        cfg = narrow(JB.get_smoke_config(ARCHS[key][0]).replace(
            param_dtype=jnp.float32, compute_dtype=jnp.float32), key)
        params = JM.build_model(cfg).init_params(jax.random.PRNGKey(0))
        inputs.update({f"params_{key}/{k}": np.asarray(v)
                       for k, v in flat(params).items()})
    np.savez(d / "inputs.npz", **inputs)
    # a part an architecture, both at once (the reference's compiles of
    # the train steps take most of each part's time)
    parts = [f"moe_{key}" for key in MOE_PARTS]
    run_sides(d, parts, [4])
    ref_res, port = {}, {}
    for part in parts:
        r, p = load(d, part, [4])
        ref_res.update(r)
        port.update(p)
    return ref_res, port


def call_digest(idx, keep) -> str:
    return digest(np.concatenate([np.asarray(idx, np.int64).ravel(),
                                  np.asarray(keep, np.int64).ravel()])
                  .reshape(2, *np.shape(idx)))


@pytest.mark.parametrize("name", [c[0] for c in MOE_PLACE_CASES])
def test_blocks_equal_reference_shards(moe, name):
    ref_res, port = moe
    want, ranks = ref_res[name], port[name]
    assert len(ranks) == 4
    got = {}
    for r in ranks:
        for path, by_coords in r.items():
            got.setdefault(path, {}).update(by_coords)
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path] == want[path], path


@pytest.mark.parametrize("mesh", MESHES)
def test_experts_split_where_the_specs_do(moe, mesh):
    """Distinct blocks of an expert weight over the 4 devices: Granite's
    6 experts whole on every rank of ``model`` (FSDP over ``data`` only),
    Qwen3-MoE's 16 split over ``model`` too; the routers replicated."""
    ref_res, _ = moe
    nd, nm = mesh
    for key, n in (("granite_e6", nd), ("qwen3_moe_e16", nd * nm)):
        for sh, prefix in (("train_4k", "0/"), ("train_4k", "1/m/"),
                           ("prefill_32k", "0/"), ("decode_32k", "0/")):
            blocks = ref_res[f"place_{key}_{sh}_m{nd}x{nm}"]
            for leaf in ("w_in", "w_out"):
                got = len(set(blocks[f"{prefix}layers/mlp/{leaf}"].values()))
                assert got == n, (key, sh, prefix, leaf)
            assert len(set(blocks[f"{prefix}layers/mlp/router"]
                           .values())) == 1


@pytest.mark.parametrize("name", TRAIN)
def test_train_matches_reference(moe, name):
    ref_res, port = moe
    want, ranks = ref_res[name], port[name]
    assert len(ranks) == 4
    for i in range(TRAIN_STEPS):
        for k in (f"loss_{i}", f"grad_norm_{i}"):
            assert len({r[k] for r in ranks}) == 1, (k, [r[k] for r in ranks])
        np.testing.assert_allclose(ranks[0][f"grad_norm_{i}"],
                                   want[f"grad_norm_{i}"], **STEP_TOL)
        np.testing.assert_allclose(ranks[0][f"loss_{i}"],
                                   want[f"loss_devices_{i}"].mean(),
                                   err_msg=f"loss step {i}", **STEP_TOL)
    for r in ranks:
        assert [r[f"digest_{i}"] for i in range(TRAIN_STEPS)] == [
            ranks[0][f"digest_{i}"] for i in range(TRAIN_STEPS)]
        assert r["moment_shapes"] == r["local_shapes"]
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, want[f"param/{k}"], err_msg=k,
                                       **PARAM_TOL)


def test_reference_train_loss_carries_its_data_shard_aux(moe):
    """Where the data axis is wider than 1 the reference's devices hold
    different losses (each its data shard's aux), on (1, 4) one."""
    ref_res, _ = moe
    for name, (_, _, mesh, _, _) in TRAIN.items():
        for i in range(TRAIN_STEPS):
            dev = ref_res[name][f"loss_devices_{i}"]
            assert (np.ptp(dev) > 1e-7) == (mesh[0] > 1), (name, i, dev)


@pytest.mark.parametrize("name", PREFILL)
def test_prefill_matches_reference(moe, name):
    ref_res, port = moe
    want, ranks = ref_res[name], port[name]
    for r in ranks:
        np.testing.assert_array_equal(r["token"], want["token"])
        for k, v in r["cache"].items():
            np.testing.assert_allclose(v, want[f"cache/{k}"], err_msg=k,
                                       **CACHE_TOL)


@pytest.mark.parametrize("name", SERVE)
def test_serve_matches_reference(moe, name):
    ref_res, port = moe
    want, ranks = ref_res[name], port[name]
    assert len(ranks) == 4
    for r in ranks:
        for i in range(SERVE_STEPS):
            np.testing.assert_array_equal(r[f"token_{i}"], want[f"token_{i}"])
            np.testing.assert_allclose(r[f"logprob_{i}"],
                                       want[f"logprob_{i}"], **CACHE_TOL)
        assert r["in_shardings"] == want["in_shardings"]
        assert r["out_shardings"] == want["out_shardings"]
        for k, block in r["cache_blocks"].items():
            shard = want["cache_blocks"][k][r["coords"]]
            assert block.shape == shard.shape, (k, r["coords"])
            np.testing.assert_allclose(block, shard, err_msg=k, **CACHE_TOL)
    # the cache's slots over data and its rows over model (decode_2d's
    # activations hold every slot, its cache the rank's)
    _, _, _, (nd, nm) = SERVE[name]
    assert ranks[0]["cache_blocks"]["k"].shape[1:3] == (16 // nd, 512 // nm)


def whole_calls(ranks, rows_split: bool):
    """The serve steps' whole-batch calls from the ranks' records: each
    rank's the same as every rank's at its data coordinate; the rows of
    the data coordinates concatenated in order where the slots are split
    over ``data`` (``seqshard``), else any rank's (``decode_2d``: every
    rank holds every slot)."""
    by = {r["coords"]: r["dispatch"] for r in ranks}
    n = len(ranks[0]["dispatch"])
    for (a, b), calls in by.items():
        assert len(calls) == n
        same = by[(a, 0)] if rows_split else by[(0, 0)]
        for (i0, k0), (i1, k1) in zip(calls, same):
            np.testing.assert_array_equal(i0, i1)
            np.testing.assert_array_equal(k0, k1)
    if not rows_split:
        return by[(0, 0)]
    heads = [by[c] for c in sorted(by) if c[1] == 0]
    return [(np.concatenate([h[j][0] for h in heads]),
             np.concatenate([h[j][1] for h in heads])) for j in range(n)]


@pytest.mark.parametrize("name", list(TRAIN) + list(PREFILL) + list(SERVE))
def test_dispatch_equals_reference(moe, name):
    ref_res, port = moe
    ref_calls, ranks = ref_res[name]["dispatch"], port[name]
    assert ref_calls
    if name in SERVE:
        assert all(where == (-1, -1) for where, _, _ in ref_calls)
        got = whole_calls(ranks, SERVE[name][1] == "granite_e6")
        assert len(got) == len(ref_calls) == NARROW["num_layers"] * SERVE_STEPS
        assert [i.shape[0] for i, _ in got] == [16] * len(got)
    else:
        # the expert-parallel blocks, each device's inside the shard_map
        assert all(min(where) >= 0 for where, _, _ in ref_calls)
        got = [c for r in ranks for c in r["dispatch"]]
    want = {call_digest(i, k) for _, i, k in ref_calls}
    assert {call_digest(i, k) for i, k in got} == want


@pytest.mark.parametrize("key", MOE_ARCHS)
def test_cases_drop_pairs(moe, key):
    """At cf 1.25 on few token ids the routers crowd: pairs are dropped in
    the train steps and in the serve steps."""
    ref_res, _ = moe
    for group in (TRAIN, SERVE):
        names = [n for n, c in group.items() if c[1] == key]
        assert names
        dropped = sum(int((~k).sum()) for n in names
                      for _, _, k in ref_res[n]["dispatch"])
        assert dropped > 0, (key, names)
