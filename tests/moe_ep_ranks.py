"""The port's side of ``tests/test_torch_moe_ep*.py``: one gloo rank.

    PYTHONPATH=src:tests python tests/moe_ep_ranks.py DIR PART WORLD RANK

joins a world of WORLD gloo ranks through a ``FileStore`` in DIR (60 s
timeout), runs every case of ``PART`` (``layer`` or ``steps``) whose mesh
has WORLD ranks, on ``make_compat_mesh(shape, ("data", "model"),
"cpu")``, and pickles its results to ``DIR/port_<PART>_w<WORLD>_r<RANK>
.pkl``.  One torch thread.  It reads ``DIR/inputs.npz``.

Layer cases: ``moe_mlp_ep`` on the rank's ``shard_experts`` slice, y and
the aux, the gradients of ``sum(y * c) + load_balance + router_z`` (the
experts' the rank's slices), the routing and drops the layer dispatched
(``_dispatch_indices`` wrapped), the expert tensors ``_expert_ffn`` was
given, the ``all_to_all_single`` calls, and ``moe_mlp_dense``'s y on the
full weights.  Step cases: 3 train steps (loss, grad norm, a digest of
the replicated leaves after each step, the final parameters) or the
prefill's tokens and cache; and the refusals of ``moe_mlp_ep``.
"""
import datetime
import hashlib
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from moe_ep_cases import (B, D_FF, LAYER_CASES, PREFILL_CASES, S, STEP_CASES,
                          flat, unflat, world_of)
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.distributed import collectives as COL
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


def cut_layer(p, cfg, mesh):
    """This rank's slice of one layer's experts (``shard_experts`` on a
    one-layer stack)."""
    tree = MOE.shard_experts({"layers": {"mlp": {k: v[None] for k, v in
                                                 p.items()}}}, cfg, mesh)
    return {k: v[0] for k, v in tree["layers"]["mlp"].items()}


def run_layer(inp, shape, cf, E):
    cfg = layer_cfg(E, cf)
    full = {k: torch.from_numpy(inp[f"layer_E{E}/{k}"])
            for k in ("router", "w_in", "w_gate", "w_out")}
    mesh = TMESH.make_compat_mesh(shape, ("data", "model"), "cpu")
    p = {k: v.clone().requires_grad_() for k, v in
         cut_layer(full, cfg, mesh).items()}
    x = torch.from_numpy(inp["layer_x"]).requires_grad_()
    c = torch.from_numpy(inp["layer_c"])
    calls = COL.CALLS["all_to_all_single"]
    with Recorder() as rec:
        y, aux = MOE.moe_mlp_ep(p, cfg, x, mesh)
        a2a_forward = COL.CALLS["all_to_all_single"] - calls
        (torch.sum(y * c) + aux["load_balance"] + aux["router_z"]).backward()
    out = {"y": y.detach().numpy(), "g_x": x.grad.numpy(),
           "aux": np.array([float(aux["load_balance"]),
                            float(aux["router_z"])]),
           "a2a_forward": a2a_forward,
           "a2a_total": COL.CALLS["all_to_all_single"] - calls,
           "dispatch": rec.dispatch, "ffn": rec.ffn,
           "coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model")),
           "y_dense": MOE.moe_mlp_dense(full, cfg, x.detach())[0].numpy()}
    out.update({f"g_{k}": v.grad.numpy() for k, v in p.items()})
    return out


def step_setup(arch):
    cfg = TB.get_smoke_config(arch).replace(param_dtype=torch.float32,
                                            compute_dtype=torch.float32)
    plan = TP.Plan(strategy="tp", fsdp=False, seq_parallel=False,
                   remat=False, microbatches=1)
    return cfg, plan


def digest(params, mask):
    """sha256 of every replicated leaf's bytes, in tree order."""
    h = hashlib.sha256()
    for leaf, expert in zip(TO.tree_leaves(params), mask):
        if not expert:
            h.update(leaf.detach().numpy().tobytes())
    return h.hexdigest()


def run_train(inp, arch, shape, steps):
    mesh = TMESH.make_compat_mesh(shape, ("data", "model"), "cpu")
    cfg, plan = step_setup(arch)
    built = TS.build_train_step(cfg, TB.ShapeConfig("local", S, B, "train"),
                                plan, mesh, False, device="cpu")
    params = MOE.shard_experts(convert.from_jax_params(
        unflat(inp, f"params_{arch}/"), device="cpu"), cfg, mesh)
    mask = MOE.expert_leaf_mask(params)
    opt = TO.init_opt_state(params, TO.AdamWConfig())
    batch = {k: torch.from_numpy(v)
             for k, v in unflat(inp, "train_batch/").items()}
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
        out[f"digest_{i}"] = digest(params, mask)
    out["params"] = {k: v.detach().numpy() for k, v in flat(params).items()}
    return out


def run_prefill(inp, arch, shape):
    mesh = TMESH.make_compat_mesh(shape, ("data", "model"), "cpu")
    cfg, plan = step_setup(arch)
    built = TS.build_prefill_step(
        cfg, TB.ShapeConfig("local", S, B, "prefill"), plan, mesh, False,
        device="cpu")
    params = MOE.shard_experts(convert.from_jax_params(
        unflat(inp, f"params_{arch}/"), device="cpu"), cfg, mesh)
    batch = {k: torch.from_numpy(v)
             for k, v in unflat(inp, "prefill_batch/").items()}
    tok, cache = built.fn(params, batch,
                          built.model.init_cache(B, TS._round_len(S + 8)))
    return {"token": tok.numpy(),
            "cache": {k: v.numpy() for k, v in cache.items()}}


def refusals(inp):
    """What ``moe_mlp_ep`` says on shapes the (2, 2) mesh does not divide
    and on expert weights not cut by ``shard_experts``."""
    cfg = layer_cfg(4, 1.0)
    full = {k: torch.from_numpy(inp[f"layer_E4/{k}"])
            for k in ("router", "w_in", "w_gate", "w_out")}
    mesh = TMESH.make_compat_mesh((2, 2), ("data", "model"), "cpu")
    x = torch.from_numpy(inp["layer_x"])
    out = {}
    for name, p, xx in (("batch_3", cut_layer(full, cfg, mesh), x[:3]),
                        ("seq_5", cut_layer(full, cfg, mesh), x[:, :5]),
                        ("uncut", full, x)):
        try:
            MOE.moe_mlp_ep(p, cfg, xx, mesh)
            out[name] = None
        except ValueError as e:
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
