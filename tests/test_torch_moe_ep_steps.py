"""The port's MoE launch steps on ``DeviceMesh``es of gloo ranks, where
``build_train_step`` and ``build_prefill_step`` take the expert-parallel
layer, against the reference's jitted steps on forced CPU meshes of the
same shapes (``test_torch_moe_ep.py``'s two sides and harness).

The cases are ``moe_ep_cases.STEP_CASES`` and ``PREFILL_CASES``: 3
train steps of the Granite-MoE and Qwen3-MoE smoke configs in f32 on
(2, 2) and (1, 4) (plan ``tp`` without FSDP, sequence parallelism or
remat, as ``test_torch_launch_moe.py``'s; B 4, S 64), and the Granite
prefill on (2, 2).  The weights are the reference's ``init_params``,
placed: each rank holds the blocks the step's ``in_shardings`` give it
(the smoke configs' 4 experts whole, since 16 does not divide 4, each
rank running its ``E_local`` of them).

* grad norm at every step within ``STEP_TOL``, every parameter after 3
  steps within ``PARAM_TOL`` (gathered from the ranks);
* the replicated parameters (the experts among them) the same bits on
  every rank after each step;
* the loss within ``STEP_TOL`` of the reference's with its aux taken as
  the mean over the data shards: the reference's loss carries data shard
  0's aux where its data axis is wider than 1 (pinned here), and its
  devices hold each shard's own, so the mean of the devices' losses is
  the loss with the mean aux;
* the prefill's tokens equal and its caches within ``CACHE_TOL``;
* ``moe_mlp_ep`` refuses shapes the mesh does not divide and a call
  without a placement.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_cpu  # noqa: F401
from moe_ep_cases import (PREFILL_CASES, STEP_CASES, flat, layer_inputs,
                          step_batches, world_of)
from repro.configs import base as JB
from repro.models import model as JM
from test_torch_launch_steps import CACHE_TOL, PARAM_TOL, STEP_TOL
from test_torch_moe_ep import load, run_sides
from repro_torch.models import moe as MOE

CASES = {name: (arch, shape, steps) for name, arch, shape, steps in
         STEP_CASES}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep_steps")
    inputs = {}
    for arch in {arch for arch, _, _ in CASES.values()}:
        cfg = JB.get_smoke_config(arch).replace(param_dtype=jnp.float32,
                                                compute_dtype=jnp.float32)
        params = JM.build_model(cfg).init_params(jax.random.PRNGKey(0))
        inputs.update({f"params_{arch}/{k}": np.asarray(v) for k, v in
                       flat(params).items()})
        vocab = cfg.vocab_size
    inputs.update(step_batches(vocab), **layer_inputs(cfg.d_model))
    np.savez(d / "inputs.npz", **inputs)
    worlds = sorted({world_of(shape) for _, shape, _ in CASES.values()})
    assert worlds == [4]
    run_sides(d, "steps", worlds)
    return load(d, "steps", worlds)


@pytest.mark.parametrize("name", CASES)
def test_train_losses_and_grad_norms_match_reference(steps, name):
    ref, port = steps
    ref, ranks = ref[name], port[name]
    for i in range(CASES[name][2]):
        for k in (f"loss_{i}", f"grad_norm_{i}"):
            assert len({r[k] for r in ranks}) == 1, (k, [r[k] for r in ranks])
        np.testing.assert_allclose(ranks[0][f"grad_norm_{i}"],
                                   ref[f"grad_norm_{i}"], **STEP_TOL)
        np.testing.assert_allclose(ranks[0][f"loss_{i}"],
                                   ref[f"loss_devices_{i}"].mean(),
                                   **STEP_TOL, err_msg=f"loss step {i}")


@pytest.mark.parametrize("name", CASES)
def test_train_parameters_match_reference(steps, name):
    ref, port = steps
    ref, ranks = ref[name], port[name]
    leaves = [k[len("param/"):] for k in ref if k.startswith("param/")]
    for r in ranks:
        assert sorted(leaves) == sorted(r["params"])
        for k in leaves:
            np.testing.assert_allclose(r["params"][k], ref[f"param/{k}"],
                                       err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("name", CASES)
def test_replicated_parameters_bit_equal_across_ranks(steps, name):
    _, port = steps
    ranks = port[name]
    arch, shape, n = CASES[name]
    for r in ranks:
        # the 4 experts whole on every rank (16 does not divide them), each
        # rank's gradient of its E_local summed over the model axis
        assert r["expert_shape"][1] == 4 > MOE.expert_padding(4, shape[1])[1]
        assert r["init_expert_shape"] == r["expert_shape"]
        for i in range(n):
            assert r[f"digest_{i}"] == ranks[0][f"digest_{i}"], (i, r["coords"])
        for k in MOE.EXPERT_KEYS:
            np.testing.assert_array_equal(r["params"][f"layers/mlp/{k}"],
                                          ranks[0]["params"][
                                              f"layers/mlp/{k}"])


def test_reference_step_loss_carries_data_shard_0_aux(steps):
    """Where the data axis is wider than 1, the reference's devices hold
    different losses (each its shard's aux) and the loss read back is
    device 0's; on (1, 4) they agree."""
    ref, _ = steps
    for name, (arch, shape, n) in CASES.items():
        for i in range(n):
            dev = ref[name][f"loss_devices_{i}"]
            np.testing.assert_array_equal(ref[name][f"loss_{i}"], dev[0])
            if shape[0] > 1:
                assert np.ptp(dev) > 1e-6, (name, i, dev)
            else:
                assert np.ptp(dev) == 0, (name, i, dev)


@pytest.mark.parametrize("name", [c[0] for c in PREFILL_CASES])
def test_prefill_matches_reference(steps, name):
    ref, port = steps
    ref, ranks = ref[name], port[name]
    for r in ranks:
        np.testing.assert_array_equal(r["token"], ref["token"])
        for k, v in r["cache"].items():
            np.testing.assert_allclose(v, ref[f"cache/{k}"], err_msg=k,
                                       **CACHE_TOL)


def test_refuses_shapes_the_mesh_does_not_divide(steps):
    _, port = steps
    for r in port["refusals"]:
        assert "does not divide" in r["batch_3"]
        assert "does not divide" in r["seq_5"]
        assert "no placement" in r["unplaced"]
