"""The port's expert-parallel MoE layer (``moe_mlp_ep`` over a
``DeviceMesh`` of gloo ranks) against the reference's ``shard_map`` layer
on forced CPU meshes of the same shapes.

The reference runs in one JAX process with four host devices
(``moe_ep_reference.py``; a test worker's JAX already has one), the port
in one process per rank (``moe_ep_ranks.py``: gloo through a
``FileStore``, a 60 s timeout, one torch thread); both read the same
numpy inputs from a seed and start together, and the fixture joins them
within ``LIMIT_S`` and fails on the first process that exits non-zero.
The cases are ``moe_ep_cases.LAYER_CASES``: the (1, 2), (2, 2), (1, 4)
and (4, 1) meshes at capacity factors 1.0 and 8.0, and 5 experts on
(1, 3) (``E_pad`` 6).  The port's layer runs placed, as the train and
prefill steps run it: each rank holds its data block of x's rows and
its blocks of the weights (``moe_ep_cases.layer_specs``: the experts
split over ``model`` where its ranks divide E, else whole there, and
FSDP over ``data``), and y leaves as its data block.

* y within 2e-5 (the reference's ``test_ep_path_matches_dense_single_
  device``), the data blocks gathered, the same bits on every rank of a
  data block;
* each (data, model) block's routing (``idx``) and drops (``keep``) as
  the layer dispatched them equal the reference's on that block, over
  ``E_pad`` experts with the block's capacity;
* the gradients of ``sum(y * c) + load_balance + router_z`` for x, the
  router and the three expert weights within rtol 1e-4, atol 1e-6 (x's
  and the experts' assembled from the ranks' blocks, the router's summed
  over the batch's axes as a step's end sums it);
* the aux is the mean over the mesh of what each device of the
  reference holds;
* each rank's experts are (E_local, ...) and see n_model * C tokens,
  and the tokens cross with 2 ``all_to_all_single`` calls forward and 2
  backward;
* at cf 1.0 on more than one rank y differs from ``moe_mlp_dense``'s,
  in both packages; at cf 8.0 (no drops) it equals it.

The reference's aux fault is pinned on (4, 1): its aux is data shard
0's, its router gradient the mean of the shards' (see ``ROADMAP.md``
section 3); the port's aux is the mean.  The launch steps on these
meshes are in ``test_torch_moe_ep_steps.py``.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from moe_ep_cases import LAYER_CASES, layer_inputs, layer_specs, world_of
from repro_torch.configs import base as TB
from repro_torch.launch import mesh as TMESH
from repro_torch.models import moe as MOE

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 240
Y_TOL = dict(atol=2e-5, rtol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
AUX_TOL = dict(rtol=1e-5, atol=0)
CASES = {name: (shape, cf, E) for name, shape, cf, E in LAYER_CASES}


def env():
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")


def run_sides(d: Path, part: str, worlds) -> None:
    """The reference's process and every world's gloo ranks on ``part``,
    all started together; fails on the first to exit non-zero (the others
    killed) or when ``LIMIT_S`` runs out."""
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "moe_ep_reference.py"),
         str(d), part], env=env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)]
    for w in worlds:
        procs += [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "moe_ep_ranks.py"), str(d),
             part, str(w), str(r)], env=env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(w)]
    deadline = time.monotonic() + LIMIT_S
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad:
                raise AssertionError(" ".join(bad[0].args) + "\n"
                                     + bad[0].stdout.read().decode()[-4000:])
            if time.monotonic() > deadline:
                raise AssertionError(f"{part}: not done in {LIMIT_S} s")
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
    """({case: reference arrays}, {case: [rank results]})."""
    ref = {f.stem[4:]: dict(np.load(f)) for f in d.glob("ref_*.npz")}
    port = {}
    for w in worlds:
        for r in range(w):
            with open(d / f"port_{part}_w{w}_r{r}.pkl", "rb") as f:
                for name, res in pickle.load(f).items():
                    port.setdefault(name, []).append(res)
    return ref, port


@pytest.fixture(scope="module")
def layer(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep_layer")
    d_model = TB.get_smoke_config("granite_moe_3b_a800m").d_model
    np.savez(d / "inputs.npz", **layer_inputs(d_model))
    worlds = sorted({world_of(shape) for shape, _, _ in CASES.values()})
    run_sides(d, "layer", worlds)
    return load(d, "layer", worlds)


def case_of(layer, name):
    ref, port = layer
    return ref[name], port[name], CASES[name]


def by_data(ranks, key):
    """The ranks' data blocks of ``key`` (dim 0) gathered, the ranks of
    one data block holding the same bits."""
    blocks = {}
    for r in ranks:
        i = r["coords"][0]
        if i in blocks:
            np.testing.assert_array_equal(r[key], blocks[i])
        blocks[i] = r[key]
    return np.concatenate([blocks[i] for i in sorted(blocks)])


@pytest.mark.parametrize("name", CASES)
def test_output_matches_reference_on_every_rank(layer, name):
    ref, ranks, (shape, cf, E) = case_of(layer, name)
    assert len(ranks) == world_of(shape)
    np.testing.assert_allclose(by_data(ranks, "y"), ref["y"], **Y_TOL)


@pytest.mark.parametrize("name", CASES)
def test_routing_and_drops_equal_per_block(layer, name):
    ref, ranks, (shape, cf, E) = case_of(layer, name)
    E_pad, _ = MOE.expert_padding(E, shape[1])
    seen = set()
    for r in ranks:
        (idx, keep, e, C), = r["dispatch"]
        i, j = r["coords"]
        block = i * shape[1] + j
        seen.add(block)
        assert e == E_pad
        np.testing.assert_array_equal(idx, ref["idx"][block])
        np.testing.assert_array_equal(keep, ref["keep"][block])
    assert seen == set(range(world_of(shape)))
    if cf == 1.0:
        assert not ref["keep"].all(), "cf 1.0 should drop pairs"


def experts(ranks, key, E, shape):
    """The ranks' blocks of an expert weight's gradient assembled by
    ``layer_specs``: d over ``data``, the experts over ``model`` where
    they are split there (else every rank of a data block equal)."""
    spec = layer_specs(E, shape)[key[2:]]
    d_dim = spec.index("data")
    split = spec[0] == "model"
    blocks = {}
    for r in ranks:
        i, j = r["coords"]
        at = (i, j if split else 0)
        if at in blocks:
            np.testing.assert_array_equal(r[key], blocks[at])
        blocks[at] = r[key]
    cols = sorted({j for _, j in blocks})
    return np.concatenate([np.concatenate(
        [blocks[i, j] for i in range(shape[0])], d_dim) for j in cols])


@pytest.mark.parametrize("name", CASES)
def test_gradients_match_reference(layer, name):
    ref, ranks, (shape, cf, E) = case_of(layer, name)
    for r in ranks:
        np.testing.assert_array_equal(r["g_router"], ranks[0]["g_router"])
    np.testing.assert_allclose(by_data(ranks, "g_x"), ref["g_x"],
                               **GRAD_TOL)
    np.testing.assert_allclose(ranks[0]["g_router"], ref["g_router"],
                               **GRAD_TOL)
    for k in ("w_in", "w_gate", "w_out"):
        g = experts(ranks, f"g_{k}", E, shape)
        assert g.shape == ref[f"g_{k}"].shape, k
        np.testing.assert_allclose(g, ref[f"g_{k}"], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("name", CASES)
def test_aux_is_the_mean_over_the_mesh(layer, name):
    ref, ranks, (shape, cf, E) = case_of(layer, name)
    want = [ref["aux_load_balance_devices"].mean(),
            ref["aux_router_z_devices"].mean()]
    for r in ranks:
        np.testing.assert_array_equal(r["aux"], ranks[0]["aux"])
    np.testing.assert_allclose(ranks[0]["aux"], want, **AUX_TOL)


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_its_experts_and_exchanges_tokens(layer, name):
    ref, ranks, (shape, cf, E) = case_of(layer, name)
    E_pad, E_local = MOE.expert_padding(E, shape[1])
    for r in ranks:
        (_, _, _, C), = r["dispatch"]
        (ffn,) = r["ffn"]
        assert ffn["w_in"][0] == ffn["w_gate"][0] == ffn["w_out"][0] \
            == E_local
        assert ffn["xe"][:2] == (E_local, shape[1] * C)
        assert (r["a2a_forward"], r["a2a_total"]) == (2, 4)


@pytest.mark.parametrize("name", CASES)
def test_against_the_dense_layer(layer, name):
    """Per-block capacities drop other pairs than the dense layer's one
    capacity at cf 1.0, in both packages; with no drops (cf 8.0) the two
    layers agree."""
    ref, ranks, (shape, cf, E) = case_of(layer, name)
    y, dense = by_data(ranks, "y"), ranks[0]["y_dense"]
    np.testing.assert_allclose(dense, ref["y_dense"], **Y_TOL)
    if cf == 8.0:
        np.testing.assert_allclose(y, dense, **Y_TOL)
        assert ref["keep"].all()
    else:
        assert np.abs(y - dense).max() > 1e-2
        assert np.abs(ref["y"] - ref["y_dense"]).max() > 1e-2


def test_reference_aux_fault_pinned_port_takes_the_mean(layer):
    """On (4, 1) the reference's aux reads data shard 0's router losses,
    while its router gradient is the mean of the four shards' gradients;
    the port's aux is the mean, the value of that gradient."""
    ref, ranks, _ = case_of(layer, "m4x1_cf1")
    shard = ref["shard_aux"]                        # (4, [lb, z])
    got = np.array([ref["aux_load_balance"], ref["aux_router_z"]])
    np.testing.assert_allclose(got, shard[0], rtol=1e-6)
    assert np.abs(shard[0] - shard.mean(0)).max() > 1e-3
    grads = ref["shard_router_grads"]
    np.testing.assert_allclose(ref["ep_aux_router_grad"], grads.mean(0),
                               rtol=1e-4, atol=1e-7)
    assert np.abs(ref["ep_aux_router_grad"] - grads[0]).max() > 1e-3
    np.testing.assert_allclose(ranks[0]["aux"], shard.mean(0), **AUX_TOL)


def test_refuses_without_a_process_group():
    assert not torch.distributed.is_initialized()
    cfg = TB.get_smoke_config("granite_moe_3b_a800m").replace(
        param_dtype=torch.float32, compute_dtype=torch.float32)
    p = MOE.init_moe_mlp(torch.Generator().manual_seed(0), cfg,
                         torch.float32, "cpu")
    x = torch.randn(2, 4, cfg.d_model)
    with pytest.raises(RuntimeError, match="no process group"):
        MOE.moe_mlp_ep(p, cfg, x, TMESH.make_local_mesh())
    with pytest.raises(RuntimeError, match="no process group"):
        TMESH.make_compat_mesh((1, 1), ("data", "model"), "cpu")
