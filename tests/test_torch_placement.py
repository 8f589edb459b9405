"""The port's placements on ``DeviceMesh``es of gloo ranks against the
reference's shardings on forced CPU meshes of the same shapes, the
sequence-sharded decode's combine, the dense decode's lse, and
``RLTrainer``'s data-parallel update.

The reference runs in one JAX process with four host devices
(``placement_reference.py``), the port in one process per rank
(``placement_ranks.py``: gloo through a ``FileStore``, a 60 s timeout,
one torch thread); both start together, and the fixture joins them within
``LIMIT_S`` and fails on the first process that exits non-zero.  The
cases are in ``placement_cases.py``.

* placement: for the train_4k, prefill_32k and decode_32k plans of the
  four dense configs at widths the specs split (``NARROW``) on (2, 2),
  (1, 4) and (4, 1), every parameter, moment, batch and cache leaf's
  block on each rank has the digest (shape and bytes) of the reference's
  ``addressable_shards`` at the same mesh coordinates;
* combine: ``decode_attention(cache_offset=, combine_axis="model")`` on
  4 ranks within 1e-5 of the reference's under ``shard_map`` (a slot
  with no live row, one whose rows lie in one block), and the serve
  step's route (each block through the dense decode's wrapper with lse,
  ``sharding.combine_over``) within 1e-5 of it;
* lse: the plain dense decode's against a float64 logsumexp;
* a replicated batch: Gemma2's train_4k plan at B 4 on (2, 2), which
  the specs replicate over ``data`` (the four-card run's case): 3 steps'
  loss and grad norm within ``STEP_TOL``, the gathered parameters within
  ``PARAM_TOL`` of the reference's jitted steps, replicated leaves the
  same bits on every rank, FSDP and model blocks held;
* update: ``RLTrainer.update`` under ``axis_rules(mesh, train_rules())``
  on (2, 1) and (4, 1), 6 rows padded to the data shards: every metric
  within ``STEP_TOL``, the parameters within ``PARAM_TOL`` of the
  reference's on its mesh after 2 updates, and the same bits on every
  rank; for Granite-MoE's smoke config too, its rows split as well (its
  routers on the whole batch: capacity, slots and aux losses);
* split aux: the MoE forward on a rank's rows of an update batch under
  the trainer's placement gives the whole batch's router losses and the
  whole batch's routing and drops for those rows.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from placement_cases import (ARCHS, COMBINE, NARROW, PLACE_CASES,
                             REPLICATED_TRAIN, TRAIN_STEPS, UPDATE_MESHES,
                             UPDATE_MOE, UPDATE_VOCAB, combine_inputs, flat,
                             world_of)
from repro.configs import base as JB
from repro.rl.session import tiny_lm_config as jtiny
from repro.models.model import build_model as jbuild
from test_torch_launch_steps import PARAM_TOL, STEP_TOL
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ref
from repro_torch.launch import mesh as TMESH

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 240
COMBINE_TOL = dict(atol=1e-5, rtol=0)


def env():
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")


def run_sides(d: Path, parts, worlds) -> None:
    """The reference's process and every world's gloo ranks on each of
    ``parts`` (a part or a list of them), all started together; fails on
    the first to exit non-zero (the others killed) or when ``LIMIT_S``
    runs out."""
    procs = []
    for part in [parts] if isinstance(parts, str) else parts:
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "placement_reference.py"),
             str(d), part], env=env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
        for w in worlds:
            procs += [subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "placement_ranks.py"),
                 str(d), part, str(w), str(r)], env=env(),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for r in range(w)]
    deadline = time.monotonic() + LIMIT_S
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad:
                raise AssertionError(" ".join(bad[0].args) + "\n"
                                     + bad[0].stdout.read().decode()[-4000:])
            if time.monotonic() > deadline:
                raise AssertionError(f"{parts}: not done in {LIMIT_S} s")
            time.sleep(0.2)
        for p in procs:
            assert p.returncode == 0, (p.args,
                                       p.stdout.read().decode()[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()


def load(d: Path, part: str, worlds):
    """(reference results, {case: [rank results]})."""
    with open(d / f"ref_{part}.pkl", "rb") as f:
        ref_res = pickle.load(f)
    port = {}
    for w in worlds:
        for r in range(w):
            with open(d / f"port_{part}_w{w}_r{r}.pkl", "rb") as f:
                for name, res in pickle.load(f).items():
                    port.setdefault(name, []).append(res)
    return ref_res, port


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    d = tmp_path_factory.mktemp("placement")
    jp = jbuild(jtiny(UPDATE_VOCAB, 64, 2)).init_params(
        jax.random.PRNGKey(3))
    inputs = {f"tiny/{k}": np.asarray(v) for k, v in flat(jp).items()}
    moe = jbuild(JB.get_smoke_config(UPDATE_MOE).replace(
        param_dtype=jax.numpy.float32, compute_dtype=jax.numpy.float32)
    ).init_params(jax.random.PRNGKey(4))
    inputs.update({f"moe/{k}": np.asarray(v) for k, v in flat(moe).items()})
    inputs.update({f"combine/{k}": v for k, v in combine_inputs().items()})
    key = REPLICATED_TRAIN[1]
    arch, extra = ARCHS[key]
    cfg = JB.get_smoke_config(arch).replace(
        param_dtype=jax.numpy.float32, compute_dtype=jax.numpy.float32,
        **dict(NARROW, **extra))
    inputs.update({f"params_{key}/{k}": np.asarray(v) for k, v in
                   flat(jbuild(cfg).init_params(jax.random.PRNGKey(0)))
                   .items()})
    np.savez(d / "inputs.npz", **inputs)
    worlds = sorted({4} | {world_of(m) for m in UPDATE_MESHES})
    run_sides(d, "main", worlds)
    return load(d, "main", worlds)


@pytest.mark.parametrize("name", [c[0] for c in PLACE_CASES])
def test_blocks_equal_reference_shards(sides, name):
    ref_res, port = sides
    want, ranks = ref_res[name], port[name]
    assert len(ranks) == 4
    got = {}
    for r in ranks:
        for path, by_coords in r.items():
            got.setdefault(path, {}).update(by_coords)
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path] == want[path], path


def test_placement_splits_where_the_specs_do(sides):
    """The cases are not all replication: the number of distinct blocks
    of a leaf over the 4 devices, in the reference's placement (which the
    port's equals, above): Qwen3's dp train batch over ``data`` only (16
    rows do not fit (data, model) at 16 x 16), its Kh 8 ``wk`` replicated
    where ``wq`` splits, Gemma2's FSDP-and-model-split ``wq`` and its
    moment, the decode cache's slots over ``data`` and rows over
    ``model``, Qwen1.5's ``bq`` heads over ``model``."""
    ref_res, _ = sides
    for name, path, n in (
            ("place_qwen3_train_4k_m2x2", "2/tokens", 2),
            ("place_qwen3_prefill_32k_m1x4", "0/layers/attn/wq", 4),
            ("place_qwen3_prefill_32k_m1x4", "0/layers/attn/wk", 1),
            ("place_gemma2_train_4k_m2x2", "0/layers/attn/wq", 4),
            ("place_gemma2_train_4k_m2x2", "1/m/layers/attn/wq", 4),
            ("place_qwen3_decode_32k_m2x2", "2/k", 4),
            ("place_qwen1_5_prefill_32k_m1x4", "0/layers/attn/bq", 4)):
        assert len(set(ref_res[name][path].values())) == n, (name, path)


def test_combine_matches_reference(sides):
    ref_res, port = sides
    want = ref_res["combine"]["out"]
    ranks = port["combine"]
    assert len(ranks) == COMBINE[5]
    for r in ranks:
        np.testing.assert_allclose(r["plain"], want, **COMBINE_TOL)
        np.testing.assert_allclose(r["kernel_route"], want, **COMBINE_TOL)
        np.testing.assert_array_equal(r["plain"], ranks[0]["plain"])
        np.testing.assert_array_equal(r["kernel_route"],
                                      ranks[0]["kernel_route"])
    # slot 0 has no row anywhere: zeros; slot 1's rows lie in block 0
    assert not want[0].any()
    lse = [r["block_lse"] for r in ranks]
    assert np.isneginf(lse[1][1]).all() and np.isfinite(lse[0][1]).all()


def test_plain_lse_matches_float64_logsumexp():
    rng = np.random.RandomState(0)
    B, S, H, Kh, D = 5, 40, 8, 2, 16
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, S, Kh, D).astype(np.float32)
    v = rng.randn(B, S, Kh, D).astype(np.float32)
    kv = np.array([0, 1, 17, 40, 55], np.int32)
    st = np.array([0, 0, 5, 39, 3], np.int32)
    for cap in (0.0, 30.0):
        out, lse = ref.ragged_decode_attention_ref(
            *(torch.from_numpy(x) for x in (q, k, v, kv)), softcap=cap,
            kv_start=torch.from_numpy(st), return_lse=True)
        assert lse.shape == (B, H) and lse.dtype == torch.float32
        s = np.einsum("bkgd,bskd->bkgs", q.reshape(B, Kh, H // Kh, D)
                      .astype(np.float64) / np.sqrt(D), k.astype(np.float64))
        if cap:
            s = np.tanh(s / cap) * cap
        for b in range(B):
            live = np.arange(S)[(np.arange(S) >= st[b])
                                & (np.arange(S) < kv[b])]
            if not len(live):
                assert np.isneginf(lse[b].numpy()).all()
                assert not out[b].any()
                continue
            x = s[b][..., live]
            m = x.max(-1, keepdims=True)
            want = (m[..., 0] + np.log(np.exp(x - m).sum(-1))).reshape(H)
            np.testing.assert_allclose(lse[b].numpy(), want, atol=2e-5,
                                       rtol=1e-6)


def test_replicated_batch_train_matches_reference(sides):
    ref_res, port = sides
    name, _, mesh, _, _ = REPLICATED_TRAIN
    want, ranks = ref_res[name], port[name]
    assert len(ranks) == 4
    for i in range(TRAIN_STEPS):
        for k in (f"loss_{i}", f"grad_norm_{i}"):
            assert len({r[k] for r in ranks}) == 1, (k, [r[k] for r in ranks])
            np.testing.assert_allclose(ranks[0][k], want[k], err_msg=k,
                                       **STEP_TOL)
    for r in ranks:
        assert [r[f"digest_{i}"] for i in range(TRAIN_STEPS)] == [
            ranks[0][f"digest_{i}"] for i in range(TRAIN_STEPS)]
        assert r["moment_shapes"] == r["local_shapes"]
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, want[f"param/{k}"], err_msg=k,
                                       **PARAM_TOL)
    d, H = NARROW["d_model"], NARROW["num_heads"]
    assert ranks[0]["local_shapes"]["layers/attn/wq"][-3:] == (
        d // mesh[0], H // mesh[1], NARROW["head_dim"])


@pytest.mark.parametrize("mesh", UPDATE_MESHES)
def test_update_matches_reference(sides, mesh):
    ref_res, port = sides
    name = f"update_m{mesh[0]}x{mesh[1]}"
    want, ranks = ref_res[name], port[name]
    assert len(ranks) == world_of(mesh)
    for r in ranks:
        # 6 rows padded to a multiple of the data shards, a slice a rank
        assert r["rows"] == [-(-6 // mesh[0])] * 2
        assert r["digests"] == ranks[0]["digests"]
        for got, exp in zip(r["recs"], want["recs"]):
            assert set(got) == set(exp)
            for k in exp:
                np.testing.assert_allclose(got[k], exp[k], err_msg=k,
                                           **STEP_TOL)
    params = {k[len("param/"):]: v for k, v in ranks[0].items()
              if k.startswith("param/")}
    assert sorted(params) == sorted(k[len("param/"):] for k in want
                                    if k.startswith("param/"))
    for k, v in params.items():
        np.testing.assert_allclose(v, want[f"param/{k}"], err_msg=k,
                                   **PARAM_TOL)


@pytest.mark.parametrize("mesh", UPDATE_MESHES)
def test_moe_update_splits_rows(sides, mesh):
    """The MoE family's update under ``train_rules()`` on a
    ``DeviceMesh``: each rank updates its slice of the padded rows, its
    routers taking the whole batch's capacity, slots and aux losses, so
    the metrics and parameters are the reference's and the same bits on
    every rank."""
    ref_res, port = sides
    name = f"update_moe_m{mesh[0]}x{mesh[1]}"
    want, ranks = ref_res[name], port[name]
    assert len(ranks) == world_of(mesh)
    for r in ranks:
        assert r["rows"] == [-(-6 // mesh[0])] * 2
        assert r["digests"] == ranks[0]["digests"]
        for got, exp in zip(r["recs"], want["recs"]):
            assert set(got) == set(exp)
            for k in exp:
                np.testing.assert_allclose(got[k], exp[k], err_msg=k,
                                           **STEP_TOL)
    for k, v in ranks[0].items():
        if k.startswith("param/"):
            np.testing.assert_allclose(v, want[k], err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("mesh", UPDATE_MESHES)
def test_split_batch_aux_equals_whole_batch(sides, mesh):
    """The MoE forward on a rank's rows of an update batch (the trainer's
    placement) against the same forward on the whole padded batch: the
    router losses within f32 summation order, every call's ``idx`` and
    ``keep`` for the rank's rows exactly the whole batch's (the capacity
    the whole batch's, each expert's slots after the rows before), at a
    capacity factor of 0.5 that drops pairs."""
    _, port = sides
    ranks = port[f"update_moe_m{mesh[0]}x{mesh[1]}"]
    dropped = 0
    for r in ranks:
        got = r["split_aux"]
        for k, v in got["aux_whole"].items():
            np.testing.assert_allclose(got["aux"][k], v, rtol=1e-6, atol=0,
                                       err_msg=k)
        assert len(got["dispatch"]) == len(got["dispatch_whole_rows"]) > 0
        for (i0, k0), (i1, k1) in zip(got["dispatch"],
                                      got["dispatch_whole_rows"]):
            np.testing.assert_array_equal(i0, i1)
            np.testing.assert_array_equal(k0, k1)
            dropped += int((~k0).sum())
    assert dropped > 0


def test_logical_constraint_is_identity_without_a_placement():
    """On a ``LocalMesh``, outside any context and without a placement
    every SPMD function is the identity."""
    x = torch.randn(2, 8, 4)
    with SH.axis_rules(TMESH.make_local_mesh(), SH.train_rules()):
        assert SH.logical_constraint(x, ("batch", "seq", "embed"),
                                     partial=True) is x
        assert SH.enter_columns(x) is x
        assert SH.weight(x, ("layers", "attn", "wq"), split=1) is x
        assert SH.model_axis() is None and SH.batch_axes() == ()
    assert SH.logical_constraint(x, ("batch", "heads", None)) is x
    assert SH.logical_to_spec(("batch", None, "heads"), SH.train_rules()) \
        == (("data",), None, "model")


def test_mesh_tool_imports_neither_jax_nor_reference():
    """``tools/mesh_run.py`` runs on the cards: like the port, it imports
    neither JAX nor the reference (``test_torch_hygiene.FORBIDDEN``)."""
    from test_torch_hygiene import FORBIDDEN
    text = (ROOT / "tools" / "mesh_run.py").read_text().splitlines()
    assert not [line for line in text if FORBIDDEN.match(line)]
    assert any("repro_torch" in line for line in text)


def test_rules_are_seen_from_autograd_threads():
    """The installed rules and placement are process-wide: a CUDA
    backward, and ``torch.utils.checkpoint``'s recomputation in it, runs
    on autograd's device threads."""
    import threading
    seen = []
    mesh = TMESH.make_local_mesh()
    with SH.axis_rules(mesh, SH.train_rules(), SH.Placement(("data",))):
        t = threading.Thread(target=lambda: seen.append(SH._current()))
        t.start()
        t.join()
    assert seen[0][0] is mesh and seen[0][2] == SH.Placement(("data",))
    assert SH._current() is None
