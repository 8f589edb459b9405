"""The port's side of ``tests/test_torch_placement*.py``: one gloo rank.

    PYTHONPATH=src:tests python tests/placement_ranks.py DIR PART WORLD RANK

joins a world of WORLD gloo ranks through a ``FileStore`` in DIR (60 s
timeout), runs every case of ``PART`` (``main`` or ``steps``, as
``placement_reference.py``) whose mesh has WORLD ranks on
``make_compat_mesh(shape, ("data", "model"), "cpu")``, and pickles its
results to ``DIR/port_<PART>_w<WORLD>_r<RANK>.pkl``.  One torch thread.
It reads ``DIR/inputs.npz``.  Part ``serve`` runs the placed serve
cases (``PLACED_SERVE_CASES``) and the refused serve steps of the
families not placed yet; part ``moe_<key>`` the MoE cases
(``MOE_*_CASES``) of arch key ``key``, each with every MoE call's
``idx``/``keep`` as the rank dispatched them.

The placement cases cut the whole input trees with ``plans.place`` by
the step's ``in_shardings`` and keep each leaf's digest; the step cases
run the placed steps on the rank's blocks and gather their results
(``plans.gather``) for the comparison, with a digest of the replicated
parameters after each train step.
"""
import dataclasses
import datetime
import hashlib
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from placement_cases import (ARCHS, B, COMBINE, MOE_IDS, MOE_PLACE_CASES,
                             MOE_PREFILL_CASES, MOE_SERVE_CASES,
                             MOE_TRAIN_CASES, PLACE_CASES,
                             PLACED_SERVE_CASES, REFUSED_MESH, REFUSED_SERVE,
                             SHAPE_BATCH,
                             narrow, serve_inputs,
                             PREFILL_CASES, PREFILL_S, REPLICATED_TRAIN, SERVE_CASES, SERVE_S,
                             SERVE_STEPS, TRAIN_CASES, TRAIN_S, TRAIN_STEPS,
                             UPDATE_MESHES, UPDATE_MOE, UPDATE_VOCAB,
                             batch_arrays, digest,
                             draw, entries, flat, leaves, reward,
                             shape_key, unflat, world_of)
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.core.buffer import BufferEntry
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import plans as TP
from repro_torch.launch import steps as TS
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.model import build_model
from repro_torch.rl import trainer as TT
from repro_torch.train import optimizer as TO

KIND = {"train_4k": ("train", TRAIN_S), "prefill_32k": ("prefill",
                                                        PREFILL_S),
        "decode_32k": ("decode", SERVE_S), "long_500k": ("decode", SERVE_S)}


def config(key):
    return narrow(TB.get_smoke_config(ARCHS[key][0]).replace(
        param_dtype=torch.float32, compute_dtype=torch.float32), key)


def mesh_of(shape):
    return TMESH.make_compat_mesh(shape, ("data", "model"), "cpu")


def coords(mesh):
    return (mesh.get_local_rank("data"), mesh.get_local_rank("model"))


def spec_leaves(tree, specs, prefix=""):
    """{path: spec tuple} beside ``leaves(tree)``."""
    if isinstance(tree, dict):
        items = [(k, tree[k], specs[k]) for k in tree]
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        items = list(zip(names, tree, specs))
    else:
        return {prefix.rstrip("/"): tuple(specs)}
    out = {}
    for k, t, s in items:
        out.update(spec_leaves(t, s, f"{prefix}{k}/"))
    return out


def run_place(name, key, shape_name, mesh_shape):
    cfg = config(key)
    plan = TP.get_plan(ARCHS[key][0], shape_name)
    kind, S = KIND[shape_name]
    mesh = mesh_of(mesh_shape)
    built = TS.build_step(cfg, TB.ShapeConfig(
        shape_name, S, SHAPE_BATCH.get(shape_name, B), kind), plan, mesh,
        False, device="cpu")
    specs = leaves(built.in_specs)
    shards = spec_leaves(built.in_specs, built.in_shardings)
    out = {}
    for path, meta in specs.items():
        x = torch.from_numpy(draw(tuple(meta.shape), shape_key(path)))
        out[path] = {coords(mesh): digest(TP.block(x, shards[path],
                                                   mesh).numpy())}
    return out


def run_combine(inp):
    Bc, H, Kh, D, R, n = COMBINE
    mesh = mesh_of((1, n))
    r = mesh.get_local_rank("model")
    q = torch.from_numpy(inp["combine/q"])
    k, v = (torch.from_numpy(inp[f"combine/{x}"])[:, r * R:(r + 1) * R]
            .contiguous() for x in ("k", "v"))
    kv = torch.from_numpy(inp["combine/kv_len"])
    with SH.axis_rules(mesh, {}):
        plain = L.decode_attention(q, k, v, kv, cache_offset=r * R,
                                   combine_axis="model")
    # the serve step's route: each block through the kernel's wrapper
    # (its plain version on the CPU) with lse, combined over the ranks
    local = (kv - r * R).clamp(0, R).to(torch.int32)
    o, lse = ops.ragged_decode_attention(q, k, v, local, return_lse=True)
    with SH.axis_rules(mesh, {}, SH.Placement()):
        ax = SH.mesh_axis(mesh, "model")
        kernel = SH.combine_over(o, lse, (ax,))
    return {"plain": plain.numpy(), "kernel_route": kernel.numpy(),
            "block_lse": lse.numpy()}


def params_digest(params):
    h = hashlib.sha256()
    for leaf in TO.tree_leaves(params):
        h.update(leaf.detach().numpy().tobytes())
    return h.hexdigest()


def update_config(which):
    if which == "tiny":
        return TB.tiny_lm_config(UPDATE_VOCAB, 64, 2)
    return TB.get_smoke_config(UPDATE_MOE).replace(
        param_dtype=torch.float32, compute_dtype=torch.float32)


class Dispatches:
    """While installed, ``repro_torch.models.moe._dispatch_indices``
    keeps each call's (idx, keep) as this rank computed them."""

    def __enter__(self):
        self.calls, self.real = [], MOE._dispatch_indices
        real, calls = self.real, self.calls

        def recorded(idx, E, C, *args):
            pos, keep = real(idx, E, C, *args)
            calls.append((idx.numpy().astype(np.int64), keep.numpy()))
            return pos, keep
        MOE._dispatch_indices = recorded
        return self

    def __exit__(self, *exc):
        MOE._dispatch_indices = self.real


def split_aux(cfg, params, mesh):
    """The MoE forward's router losses and dispatch on this rank's rows of
    an update batch under the trainer's placement, and on the whole padded
    batch unplaced (the rank's rows of its dispatch kept); at cf 0.5, so
    that pairs are dropped."""
    model = build_model(cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5)), device="cpu")
    with SH.axis_rules(mesh, SH.train_rules()):
        batch, _ = TT.entries_to_batch(entries(BufferEntry, 7), reward, 0,
                                       64, "grpo", device="cpu")
        n = SH.data_shard_count()
        with SH.axis_rules(mesh, SH.train_rules(), SH.update_placement()), \
                torch.no_grad(), Dispatches() as split:
            _, aux = model.forward(params, batch)
            i = SH.block_index(SH.batch_axes())
    whole, _ = TT.entries_to_batch(entries(BufferEntry, 7), reward, 0, 64,
                                   "grpo", device="cpu")
    whole = SH.pad_update_batch(whole, n)
    with torch.no_grad(), Dispatches() as rec:
        _, aux_whole = model.forward(params, whole)
    rows = batch["tokens"].numel()
    return {"aux": {k: float(v) for k, v in aux.items()},
            "aux_whole": {k: float(v) for k, v in aux_whole.items()},
            "dispatch": split.calls,
            "dispatch_whole_rows": [(idx[i * rows:(i + 1) * rows],
                                     keep[i * rows:(i + 1) * rows])
                                    for idx, keep in rec.calls]}


def run_update(inp, mesh_shape, which="tiny"):
    model = build_model(update_config(which), device="cpu")
    params = convert.from_jax_params(unflat(inp, f"{which}/"), device="cpu")
    trainer = TT.RLTrainer(model, params, reward, pad_id=0, max_len=64,
                           advantage_kind="grpo")
    mesh = mesh_of(mesh_shape)
    recs, digests, rows = [], [], []
    seen = {}

    real = TT.shard_update_batch

    def spy(batch, pad_token=0):
        out = real(batch, pad_token)
        seen["rows"] = int(out["tokens"].shape[0])
        return out
    TT.shard_update_batch = spy
    try:
        with SH.axis_rules(mesh, SH.train_rules()):
            for s in range(2):
                recs.append(trainer.update(entries(BufferEntry, s), s))
                digests.append(params_digest(trainer.params()))
                rows.append(seen["rows"])
    finally:
        TT.shard_update_batch = real
    out = {"recs": recs, "digests": digests, "rows": rows,
           "coords": coords(mesh)}
    if which == "moe":
        out["split_aux"] = split_aux(model.cfg, trainer.params(), mesh)
    out.update({f"param/{k}": v.detach().numpy()
                for k, v in flat(trainer.params()).items()})
    return out


def train_plan(key, micro):
    plan = TP.get_plan(ARCHS[key][0], "train_4k")
    return plan if micro is None else dataclasses.replace(
        plan, microbatches=micro)


def replicated_digest(params, pleaves):
    """sha256 of the leaves replicated on every rank (no axis in their
    spec), in tree order."""
    h = hashlib.sha256()
    for leaf, spec in zip(TO.tree_leaves(params), pleaves):
        if all(e is None for e in spec):
            h.update(leaf.detach().float().numpy().tobytes())
    return h.hexdigest()


def run_train(inp, key, mesh_shape, micro, rows, vocab=512):
    cfg = config(key)
    plan = train_plan(key, micro)
    mesh = mesh_of(mesh_shape)
    built = TS.build_train_step(cfg, TB.ShapeConfig("train_4k", TRAIN_S, rows,
                                                    "train"),
                                plan, mesh, False, device="cpu")
    pspecs, ospecs, bspecs = built.in_shardings
    full = convert.from_jax_params(unflat(inp, f"params_{key}/"),
                                   device="cpu")
    params = TP.place(full, pspecs, mesh)
    opt = TP.place(TO.init_opt_state(full, TO.AdamWConfig(
        state_dtype=plan.opt_dtype)), ospecs, mesh)
    batch = TP.place({k: torch.from_numpy(v) for k, v in
                      batch_arrays("train", TRAIN_S, vocab=vocab,
                                   rows=rows).items()}, bspecs, mesh)
    pleaves = TP.spec_leaves(pspecs)
    out = {"coords": coords(mesh),
           "local_shapes": {k: tuple(v.shape)
                            for k, v in flat(params).items()}}
    for i in range(TRAIN_STEPS):
        params, opt, m = built.fn(params, opt, batch)
        out[f"loss_{i}"] = float(m["loss"])
        out[f"grad_norm_{i}"] = float(m["grad_norm"])
        out[f"digest_{i}"] = replicated_digest(params, pleaves)
    out["params"] = {k: v.float().numpy() for k, v in
                     flat(TP.gather(params, pspecs, mesh)).items()}
    out["moment_shapes"] = {k: tuple(v.shape)
                            for k, v in flat(opt.m).items()}
    return out


def run_prefill(inp, key, mesh_shape, vocab=512):
    cfg = config(key)
    plan = TP.get_plan(ARCHS[key][0], "prefill_32k")
    mesh = mesh_of(mesh_shape)
    built = TS.build_prefill_step(
        cfg, TB.ShapeConfig("prefill_32k", PREFILL_S, B, "prefill"), plan,
        mesh, False, device="cpu")
    pspecs, bspecs, cspecs = built.in_shardings
    params = TP.place(convert.from_jax_params(
        unflat(inp, f"params_{key}/"), device="cpu"), pspecs, mesh)
    batch = TP.place({k: torch.from_numpy(v) for k, v in
                      batch_arrays("prefill", PREFILL_S,
                                   vocab=vocab).items()},
                     bspecs, mesh)
    cache = TP.place(built.model.init_cache(B, TS._round_len(PREFILL_S + 8)),
                     cspecs, mesh)
    local = {k: tuple(v.shape) for k, v in cache.items()}
    tok, cache = built.fn(params, batch, cache)
    return {"token": tok.numpy(), "cache_local_shapes": local,
            "coords": coords(mesh),
            "cache": {k: v.numpy() for k, v in
                      TP.gather(cache, cspecs, mesh).items()}}


def counting_decode():
    """(calls, restore): ``ops.ragged_decode_attention`` made to record
    each call's ``return_lse``."""
    calls, real = [], ops.ragged_decode_attention

    def counted(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*a, **kw)
    ops.ragged_decode_attention = counted
    return calls, lambda: setattr(ops, "ragged_decode_attention", real)


def placed_serve(inp, key, shape_name, mesh_shape, step_in):
    """``SERVE_STEPS`` placed serve steps of arch ``key``'s
    ``shape_name`` plan from the reference's weights, a drawn cache and
    ``step_in`` (token, kv_len): (the built step, its mesh, the rank's
    parameters and cache after them, and a dict of each step's tokens and
    log-probs gathered, the cache's local shapes and the dense decode's
    calls)."""
    cfg = config(key)
    plan = TP.get_plan(ARCHS[key][0], shape_name)
    mesh = mesh_of(mesh_shape)
    rows = len(step_in["token"])
    built = TS.build_serve_step(
        cfg, TB.ShapeConfig(shape_name, SERVE_S, rows, "decode"), plan, mesh,
        False, device="cpu")
    pspecs, tspec, cspecs, _ = built.in_shardings
    params = TP.place(convert.from_jax_params(
        unflat(inp, f"params_{key}/"), device="cpu"), pspecs, mesh)
    cache = TP.place({k: torch.from_numpy(draw(tuple(v.shape),
                                               shape_key(f"serve_cache/{k}")))
                      for k, v in built.in_specs[2].items()}, cspecs, mesh)
    tok = TP.block(torch.from_numpy(step_in["token"]), tspec, mesh)
    kv = TP.block(torch.from_numpy(step_in["kv_len"]), tspec, mesh)
    out = {"cache_local_shapes": {k: tuple(v.shape)
                                  for k, v in cache.items()}}
    calls, restore = counting_decode()
    try:
        for i in range(SERVE_STEPS):
            tok, lp, cache = built.fn(params, tok, cache, kv)
            out[f"token_{i}"] = TP.gather(tok, tspec, mesh).numpy()
            out[f"logprob_{i}"] = TP.gather(lp, tspec, mesh).numpy()
            kv = kv + 1
    finally:
        restore()
    out["decode_calls"] = calls
    return built, mesh, params, cache, out


def run_serve(inp, key, mesh_shape):
    built, mesh, _, cache, out = placed_serve(
        inp, key, "decode_32k", mesh_shape, batch_arrays("decode", SERVE_S))
    out["cache"] = {k: v.numpy() for k, v in
                    TP.gather(cache, built.in_shardings[2], mesh).items()}
    return out


def run_placed_serve(inp, key, shape_name, mesh_shape, step_in=None):
    """4 placed serve steps (``placed_serve``; ``step_in`` the token and
    kv_len, ``serve_inputs`` by default) with the rank's cache blocks
    after them, its parameter blocks' shapes and the step's spec
    trees."""
    if step_in is None:
        step_in = serve_inputs(SHAPE_BATCH.get(shape_name, B))
    built, mesh, params, cache, out = placed_serve(
        inp, key, shape_name, mesh_shape, step_in)
    _, token_shape, cache_shape, kv_shape = built.in_specs
    out.update(
        coords=coords(mesh),
        in_shardings=spec_leaves(built.in_specs, built.in_shardings),
        out_shardings=spec_leaves((token_shape, kv_shape, cache_shape),
                                  built.out_shardings),
        local_shapes={k: tuple(v.shape) for k, v in flat(params).items()},
        cache_blocks={k: v.numpy() for k, v in cache.items()})
    return out


def run_refused_serve():
    """The serve steps of the families not placed yet on a
    ``DeviceMesh``: {family: (placed, the error each raises when
    called)}."""
    out = {}
    for family, arch in REFUSED_SERVE.items():
        cfg = TB.get_smoke_config(arch).replace(param_dtype=torch.float32,
                                                compute_dtype=torch.float32)
        built = TS.build_serve_step(
            cfg, TB.ShapeConfig("decode_32k", SERVE_S, B, "decode"),
            TP.get_plan(arch, "decode_32k"), mesh_of(REFUSED_MESH), False,
            device="cpu")
        try:
            built.fn(None, None, None, None)
            error = None
        except NotImplementedError as e:
            error = str(e)
        out[family] = (built.in_shardings is not None, error)
    return out


def run_moe(inp, arch):
    """The MoE part of arch key ``arch``: placement digests, then each
    step case with its dispatches recorded."""
    out = {case[0]: run_place(*case) for case in MOE_PLACE_CASES
           if case[1] == arch}
    runs = ([(name, run_train, (inp, key, m, micro, rows, MOE_IDS))
             for name, key, m, micro, rows in MOE_TRAIN_CASES]
            + [(name, run_prefill, (inp, key, m, MOE_IDS))
               for name, key, m in MOE_PREFILL_CASES]
            + [(name, run_placed_serve,
                (inp, key, shape_name, m,
                 batch_arrays("decode", SERVE_S, vocab=MOE_IDS)))
               for name, key, shape_name, m in MOE_SERVE_CASES])
    for name, fn, args in runs:
        if args[1] != arch:
            continue
        with Dispatches() as rec:
            out[name] = fn(*args)
        out[name]["dispatch"] = rec.calls
    return out


def main(DIR, part, world, rank):
    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(DIR) / f"store_{part}_w{world}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    inp = dict(np.load(Path(DIR) / "inputs.npz"))
    out = {}
    if part == "main":
        if world == 4:
            for case in PLACE_CASES:
                out[case[0]] = run_place(*case)
            out["combine"] = run_combine(inp)
            out[REPLICATED_TRAIN[0]] = run_train(inp, *REPLICATED_TRAIN[1:])
        for m in UPDATE_MESHES:
            if world_of(m) == world:
                out[f"update_m{m[0]}x{m[1]}"] = run_update(inp, m)
                out[f"update_moe_m{m[0]}x{m[1]}"] = run_update(inp, m, "moe")
    elif part == "serve":
        for name, key, shape_name, m in PLACED_SERVE_CASES:
            out[name] = run_placed_serve(inp, key, shape_name, m)
        out["refused"] = run_refused_serve()
    elif part.startswith("moe_"):
        out = run_moe(inp, part[len("moe_"):])
    else:
        for name, key, m, micro, rows in TRAIN_CASES:
            out[name] = run_train(inp, key, m, micro, rows)
        for name, key, m in PREFILL_CASES:
            out[name] = run_prefill(inp, key, m)
        for name, key, m in SERVE_CASES:
            out[name] = run_serve(inp, key, m)
    dist.destroy_process_group()
    with open(Path(DIR) / f"port_{part}_w{world}_r{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
