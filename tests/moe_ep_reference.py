"""The reference's side of ``tests/test_torch_moe_ep*.py``: the JAX
package's expert-parallel layer and launch steps on forced CPU meshes.

Run as a script in its own process (JAX fixes its device count when it
starts, and a test worker's JAX already has one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/moe_ep_reference.py DIR PART

It reads ``DIR/inputs.npz`` (written by the test module) and writes
``DIR/ref_<case>.npz`` for each case of ``PART`` (``layer`` or
``steps``).  Meshes are ``jax.sharding.Mesh`` over the first n of the
four devices, so the (1, 3) mesh runs beside the 4-device ones.

Per layer case: ``moe_mlp_ep``'s y and the gradients of
``sum(y * c) + load_balance + router_z`` (x, router, w_in, w_gate,
w_out), the aux as read back and as each device holds it, each
(data, model) block's routing (``idx``) and drops (``keep``) by the
reference's own functions on that block, and ``moe_mlp_dense``'s y.  On
the (4, 1) mesh also each data shard's ``_route`` aux and its router
gradient (the aux fault).  Per step case: 3 ``build_train_step`` steps
(loss as read back and on each device, grad norm) and the parameters
after them, or ``build_prefill_step``'s tokens and cache.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from moe_ep_cases import (LAYER_CASES, STEP_CASES, PREFILL_CASES, flat,
                          unflat, B, S)
from repro.configs import base as JB
from repro.launch import plans as JP
from repro.launch import steps as JS
from repro.models import moe as JMOE
from repro.train import optimizer as JO


def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))


def per_device(a):
    """A "replicated" output's value on each device, in mesh order."""
    shards = sorted(a.addressable_shards, key=lambda s: s.device.id)
    return np.array([np.asarray(s.data) for s in shards])


def layer_cfg(E, cf):
    cfg = JB.get_smoke_config("granite_moe_3b_a800m")
    return cfg.replace(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                       moe=cfg.moe.__class__(
                           num_experts=E, experts_per_token=2,
                           d_ff_expert=32, capacity_factor=cf))


def blocks(x, shape):
    """Each (data, model) block of x as (T_l, d), data-major."""
    nd, nm = shape
    Bl, Sl = x.shape[0] // nd, x.shape[1] // nm
    return [x[i * Bl:(i + 1) * Bl, j * Sl:(j + 1) * Sl].reshape(
        Bl * Sl, -1) for i in range(nd) for j in range(nm)]


def block_routing(p, cfg, xb, E_pad):
    """The first lines of the reference's ``local_fn`` on one block."""
    m = cfg.moe
    logits = jnp.einsum("td,de->te", xb, p["router"])
    logits = jnp.pad(logits, ((0, 0), (0, E_pad - m.num_experts)),
                     constant_values=-1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, m.experts_per_token)
    C = JMOE._capacity(cfg, xb.shape[0])
    _, keep = JMOE._dispatch_indices(idx, E_pad, C)
    return np.asarray(idx), np.asarray(keep)


def run_layer(inp, name, shape, cf, E):
    cfg = layer_cfg(E, cf)
    p = {k: jnp.asarray(inp[f"layer_E{E}/{k}"])
         for k in ("router", "w_in", "w_gate", "w_out")}
    x = jnp.asarray(inp["layer_x"])
    c = jnp.asarray(inp["layer_c"])
    mesh = mesh_of(shape)
    E_pad = -(-E // shape[1]) * shape[1]

    def f(p, x):
        y, aux = JMOE.moe_mlp_ep(p, cfg, x, mesh)
        return (jnp.sum(y * c) + aux["load_balance"] + aux["router_z"],
                (y, aux))
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, x)
    out = {"y": np.asarray(y), "g_x": np.asarray(gx),
           "y_dense": np.asarray(JMOE.moe_mlp_dense(p, cfg, x)[0])}
    out.update({f"g_{k}": np.asarray(v) for k, v in gp.items()})
    for k in ("load_balance", "router_z"):
        out[f"aux_{k}"] = np.asarray(aux[k])
        out[f"aux_{k}_devices"] = per_device(aux[k])
    routing = [block_routing(p, cfg, xb, E_pad) for xb in blocks(x, shape)]
    out["idx"] = np.stack([r[0] for r in routing])
    out["keep"] = np.stack([r[1] for r in routing])
    if shape[1] == 1:
        # data shard i's own router losses (pmean over a 1-wide model
        # axis is the identity) and their router gradients
        def shard_aux(router, xb):
            _, _, a = JMOE._route(dict(p, router=router), cfg, xb)
            return a["load_balance"] + a["router_z"], a
        g = jax.jit(jax.grad(shard_aux, has_aux=True))
        per = [g(p["router"], xb) for xb in blocks(x, shape)]
        out["shard_aux"] = np.array([[float(a["load_balance"]),
                                      float(a["router_z"])]
                                     for _, a in per])
        out["shard_router_grads"] = np.stack([np.asarray(gr)
                                              for gr, _ in per])

        def aux_only(router):
            _, a = JMOE.moe_mlp_ep(dict(p, router=router), cfg, x, mesh)
            return a["load_balance"] + a["router_z"]
        out["ep_aux_router_grad"] = np.asarray(
            jax.jit(jax.grad(aux_only))(p["router"]))
    np.savez(Path(DIR) / f"ref_{name}.npz", **out)


def step_configs(arch):
    jcfg = JB.get_smoke_config(arch).replace(param_dtype=jnp.float32,
                                             compute_dtype=jnp.float32)
    plan = JP.Plan(strategy="tp", fsdp=False, seq_parallel=False,
                   remat=False, microbatches=1)
    return jcfg, plan


def jit(built):
    return jax.jit(built.fn, in_shardings=built.in_shardings,
                   out_shardings=built.out_shardings,
                   donate_argnums=built.donate_argnums)


def run_train(inp, name, arch, shape, steps):
    jcfg, plan = step_configs(arch)
    built = JS.build_train_step(jcfg, JB.ShapeConfig("local", S, B, "train"),
                                plan, mesh_of(shape), False)
    params = jax.tree.map(jnp.asarray, unflat(inp, f"params_{arch}/"))
    opt = JO.init_opt_state(params, JO.AdamWConfig())
    batch = {k: jnp.asarray(v) for k, v in unflat(inp, "train_batch/").items()}
    step = jit(built)
    out = {}
    for i in range(steps):
        params, opt, m = step(params, opt, batch)
        out[f"loss_{i}"] = np.asarray(m["loss"])
        out[f"loss_devices_{i}"] = per_device(m["loss"])
        out[f"grad_norm_{i}"] = np.asarray(m["grad_norm"])
    out.update({f"param/{k}": v for k, v in flat(
        jax.tree.map(np.asarray, params)).items()})
    np.savez(Path(DIR) / f"ref_{name}.npz", **out)


def run_prefill(inp, name, arch, shape):
    jcfg, plan = step_configs(arch)
    built = JS.build_prefill_step(
        jcfg, JB.ShapeConfig("local", S, B, "prefill"), plan, mesh_of(shape),
        False)
    params = jax.tree.map(jnp.asarray, unflat(inp, f"params_{arch}/"))
    batch = {k: jnp.asarray(v)
             for k, v in unflat(inp, "prefill_batch/").items()}
    max_len = JS._round_len(S + 8)
    tok, cache = jit(built)(params, batch,
                            built.model.init_cache(B, max_len))
    out = {"token": np.asarray(tok)}
    out.update({f"cache/{k}": np.asarray(v) for k, v in cache.items()})
    np.savez(Path(DIR) / f"ref_{name}.npz", **out)


if __name__ == "__main__":
    DIR, PART = sys.argv[1], sys.argv[2]
    assert len(jax.devices()) == 4, jax.devices()
    inp = dict(np.load(Path(DIR) / "inputs.npz"))
    if PART == "layer":
        for case in LAYER_CASES:
            run_layer(inp, *case)
    else:
        for name, arch, shape, steps in STEP_CASES:
            run_train(inp, name, arch, shape, steps)
        for name, arch, shape in PREFILL_CASES:
            run_prefill(inp, name, arch, shape)
