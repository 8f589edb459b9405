"""The port's side of ``tests/test_torch_moe_ep*.py``: one gloo rank.

    PYTHONPATH=src:tests python tests/moe_ep_ranks.py DIR PART WORLD RANK

joins a world of WORLD gloo ranks through a ``FileStore`` in DIR (60 s
timeout), runs every case of ``PART`` (``layer`` or ``steps``) whose mesh
has WORLD ranks, on ``make_compat_mesh(shape, ("data", "model"),
"cpu")``, and pickles its results to ``DIR/port_<PART>_w<WORLD>_r<RANK>
.pkl``.  One torch thread.  It reads ``DIR/inputs.npz``.

Layer cases: ``moe_mlp_ep`` under a placement (``layer_specs``: the
rank's blocks of the experts and its data block of x's rows), y and the
aux, the gradients of the rank's part of ``sum(y * c) + load_balance +
router_z`` (the router's summed over the batch's axes, as a step's end
sums it; the experts' the rank's blocks), the routing and drops the
layer dispatched (``_dispatch_indices`` wrapped), the expert tensors
``_expert_ffn`` was given, the ``all_to_all_single`` calls, and
``moe_mlp_dense``'s y on the full weights.  Step cases, placed (each rank on its blocks of the
trees, ``plans.place`` by the step's ``in_shardings``): 3 train steps
(loss, grad norm, a digest of the replicated leaves after each step, the
final parameters gathered) or the prefill's tokens and cache; and the
refusals of ``moe_mlp_ep``.
"""
import contextlib
import datetime
import hashlib
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from moe_ep_cases import (B, D_FF, LAYER_CASES, PREFILL_CASES, S, STEP_CASES,
                          flat, layer_specs, unflat, world_of)
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.distributed import collectives as COL
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import plans as TP
from repro_torch.launch import steps as TS
from repro_torch.models import moe as MOE
from repro_torch.train import optimizer as TO


def layer_cfg(E, cf):
    cfg = TB.get_smoke_config("granite_moe_3b_a800m")
    return cfg.replace(param_dtype=torch.float32, compute_dtype=torch.float32,
                       moe=cfg.moe.__class__(
                           num_experts=E, experts_per_token=2,
                           d_ff_expert=D_FF, capacity_factor=cf))


class Recorder:
    """Wraps ``MOE._dispatch_indices`` and ``MOE._expert_ffn`` to keep
    what the layer gave them."""

    def __init__(self):
        self.dispatch, self.ffn = [], []
        self._orig = MOE._dispatch_indices, MOE._expert_ffn

    def __enter__(self):
        disp, ffn = self._orig

        def dispatch(idx, E, C):
            pos, keep = disp(idx, E, C)
            self.dispatch.append((idx.numpy().copy(), keep.numpy().copy(),
                                  E, C))
            return pos, keep

        def expert_ffn(p, xe, act):
            self.ffn.append({k: tuple(v.shape) for k, v in p.items()}
                            | {"xe": tuple(xe.shape)})
            return ffn(p, xe, act)
        MOE._dispatch_indices, MOE._expert_ffn = dispatch, expert_ffn
        return self

    def __exit__(self, *exc):
        MOE._dispatch_indices, MOE._expert_ffn = self._orig


def layer_rules(mesh, specs, batch_axes=("data",)):
    """The train rules and a placement holding one layer's ``specs``."""
    return SH.axis_rules(mesh, SH.train_rules(), SH.Placement(
        batch_axes=batch_axes, params={"layers": {"mlp": specs}}))


def placed_layer(full, specs, mesh):
    """This rank's blocks of one layer's weights under ``specs``."""
    return {k: TP.block(v, specs[k], mesh) for k, v in full.items()}


def run_layer(inp, shape, cf, E):
    cfg = layer_cfg(E, cf)
    full = {k: torch.from_numpy(inp[f"layer_E{E}/{k}"])
            for k in ("router", "w_in", "w_gate", "w_out")}
    mesh = TMESH.make_compat_mesh(shape, ("data", "model"), "cpu")
    specs = layer_specs(E, shape)
    p = {k: v.clone().requires_grad_() for k, v in
         placed_layer(full, specs, mesh).items()}
    x_full = torch.from_numpy(inp["layer_x"])
    x = TP.block(x_full, ("data",), mesh).clone().requires_grad_()
    c = TP.block(torch.from_numpy(inp["layer_c"]), ("data",), mesh)
    calls = COL.CALLS["all_to_all_single"]
    with layer_rules(mesh, specs), Recorder() as rec:
        y, aux = MOE.moe_mlp_ep(p, cfg, x, mesh)
        a2a_forward = COL.CALLS["all_to_all_single"] - calls
        (torch.sum(y * c) + (aux["load_balance"] + aux["router_z"])
         / SH.batch_count()).backward()
        g_router = SH.sum_batch(p["router"].grad)
    out = {"y": y.detach().numpy(), "g_x": x.grad.numpy(),
           "aux": np.array([float(aux["load_balance"]),
                            float(aux["router_z"])]),
           "a2a_forward": a2a_forward,
           "a2a_total": COL.CALLS["all_to_all_single"] - calls,
           "dispatch": rec.dispatch, "ffn": rec.ffn,
           "coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model")),
           "y_dense": MOE.moe_mlp_dense(full, cfg, x_full)[0].numpy(),
           "g_router": g_router.numpy()}
    out.update({f"g_{k}": v.grad.numpy() for k, v in p.items()
                if k != "router"})
    return out


def step_setup(arch):
    cfg = TB.get_smoke_config(arch).replace(param_dtype=torch.float32,
                                            compute_dtype=torch.float32)
    plan = TP.Plan(strategy="tp", fsdp=False, seq_parallel=False,
                   remat=False, microbatches=1)
    return cfg, plan


def digest(params, specs):
    """sha256 of every leaf the specs replicate, in tree order."""
    h = hashlib.sha256()
    for leaf, spec in zip(TO.tree_leaves(params), specs):
        if all(e is None for e in spec):
            h.update(leaf.detach().numpy().tobytes())
    return h.hexdigest()


def run_train(inp, arch, shape, steps):
    """3 placed train steps from the reference's weights, each rank on
    the blocks the step's ``in_shardings`` give it."""
    mesh = TMESH.make_compat_mesh(shape, ("data", "model"), "cpu")
    cfg, plan = step_setup(arch)
    built = TS.build_train_step(cfg, TB.ShapeConfig("local", S, B, "train"),
                                plan, mesh, False, device="cpu")
    pspecs, ospecs, bspecs = built.in_shardings
    full = convert.from_jax_params(unflat(inp, f"params_{arch}/"),
                                   device="cpu")
    params = TP.place(full, pspecs, mesh)
    opt = TP.place(TO.init_opt_state(full, TO.AdamWConfig()), ospecs, mesh)
    batch = TP.place({k: torch.from_numpy(v) for k, v in
                      unflat(inp, "train_batch/").items()}, bspecs, mesh)
    pleaves = TP.spec_leaves(pspecs)
    out = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model")),
           "expert_shape": tuple(params["layers"]["mlp"]["w_in"].shape),
           "init_expert_shape": tuple(built.model.init_params(
               torch.Generator().manual_seed(0))["layers"]["mlp"]["w_in"]
               .shape)}
    for i in range(steps):
        params, opt, m = built.fn(params, opt, batch)
        out[f"loss_{i}"] = float(m["loss"])
        out[f"grad_norm_{i}"] = float(m["grad_norm"])
        out[f"digest_{i}"] = digest(params, pleaves)
    out["params"] = {k: v.detach().numpy() for k, v in
                     flat(TP.gather(params, pspecs, mesh)).items()}
    return out


def run_prefill(inp, arch, shape):
    mesh = TMESH.make_compat_mesh(shape, ("data", "model"), "cpu")
    cfg, plan = step_setup(arch)
    built = TS.build_prefill_step(
        cfg, TB.ShapeConfig("local", S, B, "prefill"), plan, mesh, False,
        device="cpu")
    pspecs, bspecs, cspecs = built.in_shardings
    params = TP.place(convert.from_jax_params(
        unflat(inp, f"params_{arch}/"), device="cpu"), pspecs, mesh)
    batch = TP.place({k: torch.from_numpy(v) for k, v in
                      unflat(inp, "prefill_batch/").items()}, bspecs, mesh)
    cache = TP.place(built.model.init_cache(B, TS._round_len(S + 8)),
                     cspecs, mesh)
    tok, cache = built.fn(params, batch, cache)
    return {"token": tok.numpy(),
            "cache": {k: v.numpy() for k, v in
                      TP.gather(cache, cspecs, mesh).items()}}


def refusals(inp):
    """What ``moe_mlp_ep`` says on shapes the (2, 2) mesh does not divide
    (B 3 whole over ``data``, S 5) and without a placement."""
    cfg = layer_cfg(4, 1.0)
    full = {k: torch.from_numpy(inp[f"layer_E4/{k}"])
            for k in ("router", "w_in", "w_gate", "w_out")}
    mesh = TMESH.make_compat_mesh((2, 2), ("data", "model"), "cpu")
    specs = layer_specs(4, (2, 2))
    p = placed_layer(full, specs, mesh)
    x = torch.from_numpy(inp["layer_x"])
    out = {}
    for name, xx, rules in (
            ("batch_3", x[:3], layer_rules(mesh, specs, batch_axes=())),
            ("seq_5", x[:2, :5], layer_rules(mesh, specs)),
            ("unplaced", x[:2], contextlib.nullcontext())):
        try:
            with rules:
                MOE.moe_mlp_ep(p, cfg, xx, mesh)
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = str(e)
    return out


def main(DIR, part, world, rank):
    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(DIR) / f"store_{part}_w{world}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    inp = dict(np.load(Path(DIR) / "inputs.npz"))
    out = {}
    if part == "layer":
        for name, shape, cf, E in LAYER_CASES:
            if world_of(shape) == world:
                out[name] = run_layer(inp, shape, cf, E)
    else:
        for name, arch, shape, steps in STEP_CASES:
            out[name] = run_train(inp, arch, shape, steps)
        for name, arch, shape in PREFILL_CASES:
            out[name] = run_prefill(inp, arch, shape)
        out["refusals"] = refusals(inp)
    dist.destroy_process_group()
    with open(Path(DIR) / f"port_{part}_w{world}_r{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
