"""The port's training launcher (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``), on the CPU, and the train step with
2 microbatches.

* ``main(["--local", "--device", "cpu", ...])`` prints the losses the
  reference's ``main`` prints for the same arch, on the reference's
  weights and batch (its ``PRNGKey(0)`` recipe, carried over: the port
  draws from a ``torch.Generator`` and cannot repeat JAX's numbers).
  The printed losses have 4 decimals; they agree within 1.5e-4 (the
  print's half step on each side, and ``STEP_TOL``).
* The reference's ``--local`` fails for the MoE family
  (``DuplicateSpecError``: its local ``dp`` plan puts the batch over
  ``model``, where the expert-parallel layer also splits the sequence);
  the port's runs, with finite losses.  A fault of the reference, pinned
  here and not copied.
* ``--no-local`` reaches the full-config branch (the reference's is dead
  code: its ``--local`` is ``store_true`` with default True): the plan of
  ``get_plan`` and the shape of ``shape_by_name``, cut by ``--seq`` and
  ``--batch``.  Here ``get_config`` is pointed at the smoke config: a
  full config does not train on this CPU.
* Qwen3-0.6B's train step with ``microbatches=2`` against the
  reference's ``lax.scan`` accumulation (``test_torch_launch_steps.py``'s
  helper and tolerances).
"""
import dataclasses
import math
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from repro.configs import base as JB
from repro.launch import train as JTRAIN
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.launch import plans as TP
from repro_torch.launch import train as TTRAIN

from test_torch_launch_steps import run_train

LOSS = re.compile(r"step (\d+): loss=(-?[0-9.]+) grad_norm=([0-9.]+)")


def _printed(text):
    return [(float(m.group(2)), float(m.group(3)))
            for m in LOSS.finditer(text)]


def _reference_inputs(arch, B, S):
    """The reference launcher's weights and batch (``train.py:53-68``)."""
    cfg = JB.get_smoke_config(arch).replace(param_dtype=jnp.float32,
                                            compute_dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    params = jbuild(cfg).init_params(key)
    batch = {
        "tokens": jax.random.randint(key, (B, S), 0, cfg.vocab_size),
        "loss_mask": jnp.ones((B, S), jnp.float32),
        "advantages": jax.random.normal(key, (B, S)),
        "old_logprobs": -2.0 * jnp.ones((B, S)),
    }
    if cfg.family == "vlm":
        batch["patch_embeds"] = jnp.zeros(
            (B, cfg.num_stub_positions, cfg.d_model), cfg.compute_dtype)
    if cfg.family == "audio":
        batch["frames"] = jnp.zeros(
            (B, cfg.num_stub_positions, cfg.d_model), cfg.compute_dtype)
    return (convert.from_jax_params(jax.tree.map(np.asarray, params),
                                    device="cpu"),
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def _use_inputs(monkeypatch, params, batch):
    """The port's launcher on the given weights and batch."""
    real = TTRAIN.build_train_step

    def build(*args, **kw):
        built = real(*args, **kw)
        built.model = dataclasses.replace(built.model,
                                          init_params=lambda g: params)
        return built
    monkeypatch.setattr(TTRAIN, "build_train_step", build)
    monkeypatch.setattr(TTRAIN, "make_batch", lambda *a: dict(batch))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi-3-vision-4.2b"])
def test_local_cli_prints_the_reference_losses(arch, monkeypatch, capsys):
    argv = ["--arch", arch, "--steps", "3", "--seq", "32", "--batch", "2"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    JTRAIN.main()
    want = _printed(capsys.readouterr().out)
    _use_inputs(monkeypatch, *_reference_inputs(arch, 2, 32))
    losses = TTRAIN.main(["--local", "--device", "cpu"] + argv)
    out = capsys.readouterr().out
    got = _printed(out)
    assert len(want) == len(got) == len(losses) == 3 and out.endswith("OK\n")
    for (wl, wg), (gl, gg), full in zip(want, got, losses):
        assert abs(gl - wl) <= 1.5e-4 and abs(gg - wg) <= 1.5e-3
        assert abs(full - wl) <= 1e-4


def test_reference_local_cli_fails_for_moe_where_the_port_runs(monkeypatch,
                                                               capsys):
    arch = "granite-moe-3b-a800m"
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--steps",
                                      "1"])
    with pytest.raises(Exception, match="duplicate entries"):
        JTRAIN.main()
    losses = TTRAIN.main(["--arch", arch, "--device", "cpu"])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert capsys.readouterr().out.endswith("OK\n")


def test_no_local_takes_the_plan_and_the_cut_shape(monkeypatch, capsys):
    seen = {}
    real = TTRAIN.build_train_step

    def build(cfg, shape, plan, mesh, multi_pod, device=None):
        seen.update(cfg=cfg, shape=shape, plan=plan, device=device)
        return real(cfg, shape, plan, mesh, multi_pod, device=device)
    monkeypatch.setattr(TTRAIN, "build_train_step", build)
    monkeypatch.setattr(TTRAIN, "get_config", TB.get_smoke_config)
    losses = TTRAIN.main(["--no-local", "--arch", "gemma2-2b", "--seq", "32",
                          "--batch", "4", "--steps", "1", "--device", "cpu"])
    assert seen["plan"] == TP.get_plan("gemma2_2b", "train_4k")
    assert seen["plan"].remat and seen["plan"].microbatches == 4
    assert (seen["shape"].name, seen["shape"].seq_len,
            seen["shape"].global_batch) == ("train_4k", 32, 4)
    assert seen["cfg"].param_dtype == torch.bfloat16      # not the f32 local
    assert len(losses) == 1 and math.isfinite(losses[0])
    with pytest.raises(SystemExit, match="decode shape"):
        TTRAIN.main(["--no-local", "--shape", "decode_32k", "--device",
                     "cpu"])


def test_train_step_with_2_microbatches_matches_reference():
    run_train("qwen3_0_6b", micro=2)


def test_zero_patch_rows_overflow_the_deep_vlm_gradient_in_the_reference():
    """The reference launcher feeds the vlm zero patch rows.  A zero
    row's RMSNorm has the Jacobian 1/sqrt(eps) (1000), so the gradient at
    those rows grows up to ~1000x a layer: at 32 layers (Phi-3-Vision's
    depth) of the smoke width the reference's train step's grad norm is
    NaN.  The port's ``make_batch``
    draws the rows from N(0, 1) and its step stays finite (the port's
    step on zero rows is NaN too: the arithmetic is the same)."""
    L, B, S = 32, 2, 32
    jcfg = JB.get_smoke_config("phi_3_vision_4_2b").replace(
        num_layers=L, param_dtype=jnp.float32, compute_dtype=jnp.float32)
    from repro.launch import mesh as JMESH
    from repro.launch import plans as JP
    from repro.launch import steps as JS
    from repro.train import optimizer as JO
    jplan = JP.Plan(strategy="dp", fsdp=False, seq_parallel=False,
                    remat=False)
    jb = JS.build_train_step(jcfg, JB.ShapeConfig("local", S, B, "train"),
                             jplan, JMESH.make_local_mesh(), False)
    key = jax.random.PRNGKey(0)
    jp = jb.model.init_params(key)
    batch = {"tokens": jax.random.randint(key, (B, S), 0, jcfg.vocab_size),
             "loss_mask": jnp.ones((B, S)),
             "advantages": jax.random.normal(key, (B, S)),
             "old_logprobs": -2.0 * jnp.ones((B, S)),
             "patch_embeds": jnp.zeros((B, jcfg.num_stub_positions,
                                        jcfg.d_model))}
    _, _, jm = jax.jit(jb.fn)(jp, JO.init_opt_state(jp, JO.AdamWConfig()),
                              batch)
    assert np.isnan(float(jm["grad_norm"]))

    from repro_torch.launch import mesh as TMESH
    from repro_torch.launch import steps as TS
    from repro_torch.train import optimizer as TO
    tcfg = TB.get_smoke_config("phi_3_vision_4_2b").replace(
        num_layers=L, param_dtype=torch.float32, compute_dtype=torch.float32)
    tb = TS.build_train_step(tcfg, TB.ShapeConfig("local", S, B, "train"),
                             TP.Plan(strategy="dp", fsdp=False,
                                     seq_parallel=False, remat=False),
                             TMESH.make_local_mesh(), False, device="cpu")
    norms = {}
    for rows in ("random", "zero"):
        tp = tb.model.init_params(torch.Generator().manual_seed(0))
        tbatch = TTRAIN.make_batch(tcfg, B, S, "cpu",
                                   torch.Generator().manual_seed(1))
        if rows == "zero":
            tbatch["patch_embeds"].zero_()
        _, _, tm = tb.fn(tp, TO.init_opt_state(tp, TO.AdamWConfig()), tbatch)
        norms[rows] = float(tm["grad_norm"])
    assert math.isfinite(norms["random"]) and math.isnan(norms["zero"])
