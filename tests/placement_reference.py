"""The reference's side of ``tests/test_torch_placement*.py``: the JAX
package's placements, launch steps, distributed decode and trainer on
forced CPU meshes.

Run as a script in its own process (JAX fixes its device count when it
starts, and a test worker's JAX already has one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/placement_reference.py DIR PART

It reads ``DIR/inputs.npz`` (written by the test module) and writes
``DIR/ref_<PART>.pkl``.  Meshes are ``jax.sharding.Mesh`` over the first
n of the four devices.  Parts:

* ``main``: per placement case the sha256 of every input leaf's block
  on each device (``addressable_shards`` of the leaf placed by the
  step's ``in_shardings``), keyed by the device's mesh coordinates; the
  combine case's ``decode_attention`` under ``shard_map`` (the cache's
  rows over ``model``); ``RLTrainer.update`` under ``train_rules()`` on
  (2, 1) and (4, 1).
* ``steps``: per train case 3 jitted ``build_train_step`` steps (loss,
  grad norm) and the parameters after them; per prefill case the tokens
  and the cache; per serve case 4 steps' tokens, log-probs and the cache
  after them.
* ``serve``: per placed serve case 4 jitted steps' tokens and log-probs,
  each cache leaf's ``addressable_shards`` after them keyed by the
  device's mesh coordinates, and the step's spec trees.
* ``moe_<key>``: the MoE cases (``MOE_*_CASES``) of arch key ``key``:
  the placement digests, and
  the train, prefill and serve steps as above (the train's loss also on
  each device: its aux is the device's data shard's), each with every
  MoE call's ``idx``/``keep`` (``_dispatch_indices`` recorded through
  ``jax.debug.callback``: the whole call's under the compiler's
  partitioning, a device's block inside the expert-parallel
  ``shard_map``, keyed by its mesh coordinates).
"""
import dataclasses
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from placement_cases import (ARCHS, B, COMBINE, MOE_IDS, MOE_PLACE_CASES,
                             MOE_PREFILL_CASES, MOE_SERVE_CASES,
                             MOE_TRAIN_CASES, PLACE_CASES,
                             PLACED_SERVE_CASES, SHAPE_BATCH, narrow,
                             serve_inputs,
                             PREFILL_CASES, PREFILL_S, REPLICATED_TRAIN, SERVE_CASES, SERVE_S,
                             SERVE_STEPS, TRAIN_CASES, TRAIN_S, TRAIN_STEPS,
                             UPDATE_MESHES, UPDATE_MOE, UPDATE_VOCAB,
                             batch_arrays, digest,
                             draw, entries, flat, leaves, reward,
                             shape_key, unflat)
from repro.configs import base as JB
from repro.core.buffer import BufferEntry
from repro.distributed.sharding import axis_rules, train_rules
from repro.launch import plans as JP
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models.model import build_model
from repro.rl import trainer as JT
from repro.rl.session import tiny_lm_config
from repro.train import optimizer as JO

KIND = {"train_4k": ("train", TRAIN_S), "prefill_32k": ("prefill",
                                                        PREFILL_S),
        "decode_32k": ("decode", SERVE_S), "long_500k": ("decode", SERVE_S)}


def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))


def config(key):
    return narrow(JB.get_smoke_config(ARCHS[key][0]).replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32), key)


def coords(mesh, device):
    """A device's (data, model) coordinates in ``mesh``."""
    idx = np.argwhere(mesh.devices == device)[0]
    return tuple(int(i) for i in idx)


def run_place(name, key, shape_name, mesh_shape):
    cfg = config(key)
    plan = JP.get_plan(ARCHS[key][0], shape_name)
    kind, S = KIND[shape_name]
    mesh = mesh_of(mesh_shape)
    built = JS.build_step(cfg, JB.ShapeConfig(
        shape_name, S, SHAPE_BATCH.get(shape_name, B), kind), plan, mesh,
        False)
    specs = leaves(built.in_specs)
    shards = leaves(built.in_shardings)
    out = {}
    for path, sds in specs.items():
        x = draw(sds.shape, shape_key(path))
        placed = jax.device_put(x, shards[path])
        out[path] = {coords(mesh, s.device): digest(np.asarray(s.data))
                     for s in placed.addressable_shards}
    return out


def run_combine(inp):
    Bc, H, Kh, D, R, n = COMBINE
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "model"))
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    def local(q, k, v, kv_len):
        off = jax.lax.axis_index("model") * R
        return JL.decode_attention(q, k, v, kv_len, cache_offset=off,
                                   combine_axis="model")
    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P(None, "model"), P(None, "model"), P()),
                   out_specs=P())
    out = jax.jit(fn)(*(jnp.asarray(inp[f"combine/{k}"])
                        for k in ("q", "k", "v", "kv_len")))
    return {"out": np.asarray(out)}


def update_config(which):
    if which == "tiny":
        return tiny_lm_config(UPDATE_VOCAB, 64, 2)
    return JB.get_smoke_config(UPDATE_MOE).replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32)


def run_update(inp, mesh_shape, which="tiny"):
    model = build_model(update_config(which))
    params = jax.tree.map(jnp.asarray, unflat(inp, f"{which}/"))
    trainer = JT.RLTrainer(model, params, reward, pad_id=0, max_len=64,
                           advantage_kind="grpo")
    recs = []
    with axis_rules(mesh_of(mesh_shape), train_rules()):
        for s in range(2):
            recs.append(trainer.update(entries(BufferEntry, s), s))
    out = {"recs": recs}
    out.update({f"param/{k}": np.asarray(v)
                for k, v in flat(trainer.params()).items()})
    return out


def jit(built):
    return jax.jit(built.fn, in_shardings=built.in_shardings,
                   out_shardings=built.out_shardings,
                   donate_argnums=built.donate_argnums)


def train_plan(key, micro):
    plan = JP.get_plan(ARCHS[key][0], "train_4k")
    return plan if micro is None else dataclasses.replace(
        plan, microbatches=micro)


class Dispatches:
    """While installed, ``repro.models.moe._dispatch_indices`` hands each
    call's (idx, keep) to the host with ``jax.debug.callback``, with the
    device's (data, model) coordinates inside a ``shard_map`` and (-1,
    -1) for a call the compiler partitions (whose arrays are the whole
    call's)."""

    def __enter__(self):
        self.calls, self.real = [], JMOE._dispatch_indices
        real, calls = self.real, self.calls

        def keep(idx, k, a, b):
            calls.append(((int(a), int(b)), np.asarray(idx, np.int64),
                          np.asarray(k)))

        def recorded(idx, E, C):
            pos, kp = real(idx, E, C)
            try:
                where = (jax.lax.axis_index("data"),
                         jax.lax.axis_index("model"))
            except Exception:
                where = (jnp.int32(-1), jnp.int32(-1))
            jax.debug.callback(keep, idx, kp, *where)
            return pos, kp
        JMOE._dispatch_indices = recorded
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        JMOE._dispatch_indices = self.real


def per_device(a):
    """A "replicated" output's value on each device, in device order."""
    shards = sorted(a.addressable_shards, key=lambda s: s.device.id)
    return np.array([np.asarray(s.data) for s in shards])


def run_train(inp, key, mesh_shape, micro, rows, vocab=512):
    cfg = config(key)
    plan = train_plan(key, micro)
    built = JS.build_train_step(cfg, JB.ShapeConfig("train_4k", TRAIN_S, rows,
                                                    "train"),
                                plan, mesh_of(mesh_shape), False)
    params = jax.tree.map(jnp.asarray, unflat(inp, f"params_{key}/"))
    opt = JO.init_opt_state(params, JO.AdamWConfig(
        state_dtype=plan.opt_dtype))
    batch = {k: jnp.asarray(v)
             for k, v in batch_arrays("train", TRAIN_S, vocab=vocab,
                                      rows=rows).items()}
    step = jit(built)
    out = {}
    for i in range(TRAIN_STEPS):
        params, opt, m = step(params, opt, batch)
        out[f"loss_{i}"] = float(m["loss"])
        out[f"loss_devices_{i}"] = per_device(m["loss"])
        out[f"grad_norm_{i}"] = float(m["grad_norm"])
    out.update({f"param/{k}": np.asarray(v, dtype=np.float32)
                for k, v in flat(params).items()})
    return out


def run_prefill(inp, key, mesh_shape, vocab=512):
    cfg = config(key)
    plan = JP.get_plan(ARCHS[key][0], "prefill_32k")
    built = JS.build_prefill_step(
        cfg, JB.ShapeConfig("prefill_32k", PREFILL_S, B, "prefill"), plan,
        mesh_of(mesh_shape), False)
    params = jax.tree.map(jnp.asarray, unflat(inp, f"params_{key}/"))
    batch = {k: jnp.asarray(v)
             for k, v in batch_arrays("prefill", PREFILL_S,
                                      vocab=vocab).items()}
    max_len = JS._round_len(PREFILL_S + 8)
    tok, cache = jit(built)(params, batch,
                            built.model.init_cache(B, max_len))
    out = {"token": np.asarray(tok)}
    out.update({f"cache/{k}": np.asarray(v) for k, v in cache.items()})
    return out


def run_serve(inp, key, mesh_shape):
    cfg = config(key)
    plan = JP.get_plan(ARCHS[key][0], "decode_32k")
    built = JS.build_serve_step(
        cfg, JB.ShapeConfig("decode_32k", SERVE_S, B, "decode"), plan,
        mesh_of(mesh_shape), False)
    params = jax.tree.map(jnp.asarray, unflat(inp, f"params_{key}/"))
    _, _, cache_shape, _ = built.in_specs
    cache = {k: jnp.asarray(draw(v.shape, shape_key(f"serve_cache/{k}")))
             for k, v in cache_shape.items()}
    step_in = batch_arrays("decode", SERVE_S)
    tok, kv = jnp.asarray(step_in["token"]), jnp.asarray(step_in["kv_len"])
    step = jit(built)
    out = {}
    for i in range(SERVE_STEPS):
        tok, lp, cache = step(params, tok, cache, kv)
        out[f"token_{i}"] = np.asarray(tok)
        out[f"logprob_{i}"] = np.asarray(lp)
        kv = kv + 1
    out.update({f"cache/{k}": np.asarray(v) for k, v in cache.items()})
    return out


def spec_tuples(shapes, shardings):
    """{path: spec tuple, padded with None to the leaf's rank} of a tree
    of ``NamedSharding`` beside its shapes."""
    out = {}
    for path, ns in leaves(shardings).items():
        spec = tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                     for e in ns.spec)
        nd = len(leaves(shapes)[path].shape)
        out[path] = spec + (None,) * (nd - len(spec))
    return out


def run_placed_serve(inp, key, shape_name, mesh_shape, step_in=None):
    cfg = config(key)
    plan = JP.get_plan(ARCHS[key][0], shape_name)
    rows = SHAPE_BATCH.get(shape_name, B)
    mesh = mesh_of(mesh_shape)
    built = JS.build_serve_step(
        cfg, JB.ShapeConfig(shape_name, SERVE_S, rows, "decode"), plan, mesh,
        False)
    params = jax.tree.map(jnp.asarray, unflat(inp, f"params_{key}/"))
    _, token_shape, cache_shape, kv_shape = built.in_specs
    cache = {k: jnp.asarray(draw(v.shape, shape_key(f"serve_cache/{k}")))
             for k, v in cache_shape.items()}
    step_in = serve_inputs(rows) if step_in is None else step_in
    tok, kv = jnp.asarray(step_in["token"]), jnp.asarray(step_in["kv_len"])
    step = jit(built)
    out = {"in_shardings": spec_tuples(built.in_specs, built.in_shardings),
           "out_shardings": spec_tuples(
               (token_shape, kv_shape, cache_shape), built.out_shardings)}
    for i in range(SERVE_STEPS):
        tok, lp, cache = step(params, tok, cache, kv)
        out[f"token_{i}"] = np.asarray(tok)
        out[f"logprob_{i}"] = np.asarray(lp)
        kv = kv + 1
    out["cache_blocks"] = {
        k: {coords(mesh, s.device): np.asarray(s.data)
            for s in v.addressable_shards} for k, v in cache.items()}
    return out


if __name__ == "__main__":
    DIR, PART = sys.argv[1], sys.argv[2]
    assert len(jax.devices()) == 4, jax.devices()
    inp = dict(np.load(Path(DIR) / "inputs.npz"))
    res = {}
    if PART == "main":
        for case in PLACE_CASES:
            res[case[0]] = run_place(*case)
        res["combine"] = run_combine(inp)
        res[REPLICATED_TRAIN[0]] = run_train(inp, *REPLICATED_TRAIN[1:])
        for m in UPDATE_MESHES:
            res[f"update_m{m[0]}x{m[1]}"] = run_update(inp, m)
            res[f"update_moe_m{m[0]}x{m[1]}"] = run_update(inp, m, "moe")
    elif PART == "serve":
        for name, key, shape_name, m in PLACED_SERVE_CASES:
            res[name] = run_placed_serve(inp, key, shape_name, m)
    elif PART.startswith("moe_"):
        arch = PART[len("moe_"):]
        for case in MOE_PLACE_CASES:
            if case[1] == arch:
                res[case[0]] = run_place(*case)
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
                res[name] = fn(*args)
            res[name]["dispatch"] = rec.calls
    else:
        for name, key, m, micro, rows in TRAIN_CASES:
            res[name] = run_train(inp, key, m, micro, rows)
        for name, key, m in PREFILL_CASES:
            res[name] = run_prefill(inp, key, m)
        for name, key, m in SERVE_CASES:
            res[name] = run_serve(inp, key, m)
    with open(Path(DIR) / f"ref_{PART}.pkl", "wb") as f:
        pickle.dump(res, f)
