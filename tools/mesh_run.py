"""The dense family's placed launch steps across four cards, against the
same steps on one card.

    torchrun --standalone --nproc-per-node 4 tools/mesh_run.py mesh
    python3 tools/mesh_run.py one_card
    python3 tools/mesh_run.py compare

``mesh`` (four ranks, NCCL; ``torchrun`` gives each its rank and the
rendezvous on localhost):

* Gemma2-2B at full width, bf16, under its train_4k plan (``tp``: FSDP
  over ``data``, the heads, FFN columns and vocabulary over ``model``,
  the sequence-parallel residual, remat, 4 microbatches) on the (2, 2)
  mesh, B ``--batch`` (4: the specs then replicate the batch over
  ``data``; one card cannot hold 16), S 4096, 2 steps, at 8 layers
  (``chip_smoke.LAUNCH_DEPTH``) and again at its 26: each rank's loss,
  grad norm, update ms (host clock around the synchronised step) and
  peak GB; then the 8-layer steps in f32 (``F32_RUNS``): at B 4, S 4096,
  and at B 16, S 1024, where the batch is split over ``data`` (the
  data ranks' gradients summed, the FSDP gradients reduce-scattered);
* the serve parts (``SERVE_RUNS``), bf16, full widths, 8 steps from
  kv_len S - 8 over a random cache (``random_cache``: a (leaf, layer)
  slab at a time from its own seed, each rank keeping its block):
  Qwen3-0.6B's decode_32k plan (``dp``; the 33,280 rows over ``model``)
  on (1, 4) at B 8; Gemma2-2B's decode_32k plan (``tp``, the slots over
  ``data``, its ring's 4,096 rows and the global rows over ``model``) on
  (2, 2) at its 26 layers, B 32; its long_500k plan (B 1, both caches'
  rows over ``("data", "model")``) on (2, 2) and (1, 4); the
  ``decode_2d`` plans of Qwen1.5-110B at 8 layers and Nemotron-4-340B at
  2 on (2, 2), B 8 (the activations' d over ``data``, no weight
  gathered), and Qwen1.5-110B's at 2 layers again in f32: tokens,
  log-probs, step ms, the dense decode's launches and the collectives a
  step.

``one_card`` runs the 8-layer Gemma2 steps (bf16, the f32 runs and the
bf16 control ``train_8_halves``: the row-parallel products, ``wo`` and
``w_out``, summed from two halves each rounded to bf16, as the (2, 2)
mesh forms them) and each serve run on card 0 from the same seeds on
``make_local_mesh()`` (the serve steps with the top-two logit gap at
every step); ``compare`` holds the four-card loss and grad norm to one
card's (``TRAIN_TOL`` in bf16, ``F32_TOL`` in f32: in f32 the two differ
only in the order of their sums, so a gap beyond it is the placement's)
and each slot's first token apart from one card's to a near tie there
(``NEAR_TIE``; its later tokens follow a different input; in f32
``F32_NEAR_TIE``, and the log-probs before it within ``SERVE_F32_TOL``
of one card's), reports the
control's gaps beside the mesh's and one traced serve step a rank, and
exits 1 on any miss.  Inputs and weights come
from seeds (Gemma2's ``wo`` and ``w_out`` scaled 8x at init, as
``chip_smoke.LAUNCH_SCALES``).  Each part writes
``chiprun_out/mesh_run/<part>*.json``; ``--device cpu --smoke`` runs the
same at narrow widths on gloo (the CPU rehearsal).
"""
import argparse
import datetime
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "chiprun_out" / "mesh_run"

TRAIN = ("gemma2_2b", "train_4k", 4096)
TRAIN_DEPTHS = (8, 26)
# part -> (arch, shape, S, B, layers or None for the published depth,
# mesh, f32); the cuts (batches, depths) are PERF.md section 4's
SERVE_RUNS = {
    "serve": ("qwen3_0_6b", "decode_32k", 32_768, 8, None, (1, 4), False),
    "serve_gemma2_decode_32k": ("gemma2_2b", "decode_32k", 32_768, 32, None,
                                (2, 2), False),
    "serve_gemma2_long_500k_m2x2": ("gemma2_2b", "long_500k", 524_288, 1,
                                    None, (2, 2), False),
    "serve_gemma2_long_500k_m1x4": ("gemma2_2b", "long_500k", 524_288, 1,
                                    None, (1, 4), False),
    "serve_qwen1_5_decode_2d": ("qwen1_5_110b", "decode_32k", 32_768, 8, 8,
                                (2, 2), False),
    "serve_nemotron_decode_2d": ("nemotron_4_340b", "decode_32k", 32_768, 8,
                                 2, (2, 2), False),
    # the decode_2d sums in f32 (2 layers: 21 GB of f32 weights on one
    # card): the placement against one card without bf16's rounding
    "serve_qwen1_5_decode_2d_f32": ("qwen1_5_110b", "decode_32k", 32_768, 8,
                                    2, (2, 2), True),
}
SERVE_STEPS = 8
TRAIN_STEPS = 2
SCALES = {"wo": 8.0, "w_out": 8.0}
CACHE_SCALE = 0.5
# four cards against one in bf16: the row-parallel products' partial sums
# are rounded to bf16 on each rank before they are added, and the
# vocabulary's logsumexp is taken in two halves (stated before the run)
TRAIN_TOL = {"loss_rel": 1e-2, "grad_norm_rel": 5e-2}
# the 8-layer steps in f32: name -> (batch, seq); the smoke rehearsal
# runs them at S 64
F32_RUNS = {"train_8_f32": (4, 4096), "train_8_f32_b16": (16, 1024)}
# four cards against one in f32, per step (stated before the run): step 1
# differs only in the order of f32 sums; AdamW's first step is about
# lr * sign(g), so an element whose gradient is near 0 may move the other
# way on the other side, and step 2 is held more loosely
F32_TOL = {"loss_rel": (1e-5, 1e-3), "grad_norm_rel": (1e-5, 1e-3)}
# a slot's first token apart from one card's must be a near tie there (its
# top-two logits within this); later ones follow from a different input
NEAR_TIE = 0.05
# the f32 serve parts: a parting only below this top-two gap, and every
# log-prob before it within SERVE_F32_TOL nats of one card's (both stated
# before the run; the f32 forward's logprob limit)
F32_NEAR_TIE = 1e-3
SERVE_F32_TOL = 1e-3
SMOKE = dict(num_layers=2, d_model=64, num_heads=16, num_kv_heads=8,
             head_dim=8, d_ff=128, vocab_size=512)


def card():
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def config(torch, arch, smoke, layers=None, f32=False):
    from repro_torch.configs.base import get_config, get_smoke_config
    if smoke:
        return get_smoke_config(arch).replace(
            param_dtype=torch.float32, compute_dtype=torch.float32, **SMOKE)
    cfg = get_config(arch)
    if f32:
        cfg = cfg.replace(param_dtype=torch.float32,
                          compute_dtype=torch.float32)
    return cfg.replace(num_layers=layers) if layers else cfg


def f32_runs(torch, dev, mesh, smoke):
    """The 8-layer Gemma2 steps in f32 on ``mesh`` (``F32_RUNS``)."""
    runs = {}
    for name, (B, S) in F32_RUNS.items():
        cfg = config(torch, TRAIN[0], smoke, 2 if smoke else TRAIN_DEPTHS[0],
                     f32=True)
        runs[name] = train_run(torch, dev, mesh, cfg, B, 64 if smoke else S)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return runs


def scale(torch, params):
    """Gemma2's ``wo`` and ``w_out`` times ``SCALES`` (at the init scale
    its tied, capped head is one-hot: every token's log-prob 0)."""
    with torch.no_grad():
        for leaf, f in SCALES.items():
            params["layers"]["attn" if leaf == "wo" else "mlp"][leaf].mul_(f)


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_gb(torch, dev):
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)


def timed(torch, dev, fn, *args):
    sync(torch, dev)
    t0 = time.perf_counter()
    out = fn(*args)
    sync(torch, dev)
    return out, (time.perf_counter() - t0) * 1e3


def train_run(torch, dev, mesh, cfg, B, S):
    """``TRAIN_STEPS`` steps of Gemma2's train_4k plan on ``mesh`` (placed
    on a ``DeviceMesh``): loss, grad norm, ms and peak GB."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import plans, steps, train
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    plan = plans.get_plan(TRAIN[0], TRAIN[1])
    built = steps.build_train_step(cfg, ShapeConfig(TRAIN[1], S, B, "train"),
                                   plan, mesh, False, device=dev)
    params = built.model.init_params(torch.Generator(device=dev)
                                     .manual_seed(0))
    scale(torch, params)
    opt = init_opt_state(params, AdamWConfig(state_dtype=plan.opt_dtype))
    batch = train.make_batch(cfg, B, S, dev, torch.Generator().manual_seed(1))
    if built.in_shardings is not None:
        pspecs, ospecs, bspecs = built.in_shardings
        params, opt, batch = (plans.place(params, pspecs, mesh),
                              plans.place(opt, ospecs, mesh),
                              plans.place(batch, bspecs, mesh))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"loss": [], "grad_norm": [], "ms": []}
    for _ in range(TRAIN_STEPS):
        (params, opt, m), ms = timed(torch, dev, built.fn, params, opt, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["ms"].append(ms)
    out.update(peak_gb=peak_gb(torch, dev), layers=cfg.num_layers, batch=B,
               seq=S, microbatches=plan.microbatches,
               local_wq=list(params["layers"]["attn"]["wq"].shape),
               local_embed=list(params["embed"].shape))
    return out


def profile_call(torch, dev, fn):
    """One call of ``fn`` under torch.profiler: wall ms (host clock,
    synchronised), the summed device ms of its kernels, the collectives'
    share of it, and the costliest host ops."""
    from torch.profiler import ProfilerActivity, profile
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        wall = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    cuda = [r for r in rows
            if r.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(r.self_device_time_total for r in cuda) / 1e3
    host = sorted((r for r in rows
                   if r.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: -r.self_cpu_time_total)[:10]
    return {"wall_ms": wall, "device_ms": dev_ms,
            "nccl_device_ms": sum(r.self_device_time_total for r in cuda
                                  if "nccl" in r.key.lower()) / 1e3,
            "kernel_launches": sum(r.count for r in cuda),
            "top_host_ops_ms": {r.key[:60]: r.self_cpu_time_total / 1e3
                                for r in host}}


def one_card_key(run):
    """The one-card run a serve part is compared with (both long_500k
    parts share one)."""
    arch, shape, S, B, layers, _, f32 = run
    return f"serve_{arch}_{shape}_b{B}_l{layers}" + ("_f32" if f32 else "")


def random_cache(torch, dev, built, mesh):
    """The serve cache from seeds, one (leaf, layer) slab at a time, each
    slab cut to the rank's block by the step's cache specs (on one card
    the whole): no rank holds more than its blocks and one slab."""
    from repro_torch.launch import plans
    cspecs = built.in_shardings[2] if built.in_shardings else None
    out = {}
    for i, (name, meta) in enumerate(sorted(built.in_specs[2].items())):
        spec = cspecs[name][1:] if cspecs else (None,) * (meta.ndim - 1)
        local = None
        for layer in range(meta.shape[0]):
            g = torch.Generator(device=dev).manual_seed(1000 * i + layer)
            slab = torch.empty(meta.shape[1:], dtype=meta.dtype, device=dev)
            slab.normal_(generator=g).mul_(CACHE_SCALE)
            blk = plans.block(slab, spec, mesh)
            if local is None:
                local = torch.empty((meta.shape[0],) + tuple(blk.shape),
                                    dtype=meta.dtype, device=dev)
            local[layer].copy_(blk)
            del slab, blk
        out[name] = local
    return out


def serve_setup(torch, dev, mesh, run, smoke):
    """A serve part's step, weights, cache, token and kv_len (S - 8), all
    from seeds, placed on ``mesh`` where the step is."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import plans, steps
    arch, shape, S, B, layers, _, f32 = run
    S = 500 if smoke else S
    cfg = config(torch, arch, smoke, layers, f32)
    plan = plans.get_plan(arch, shape)
    built = steps.build_serve_step(cfg, ShapeConfig(shape, S, B, "decode"),
                                   plan, mesh, False, device=dev)
    params = built.model.init_params(torch.Generator(device=dev)
                                     .manual_seed(0))
    if arch == TRAIN[0]:        # Gemma2's capped tied head not one-hot
        scale(torch, params)
    if built.in_shardings is not None:
        params = plans.place(params, built.in_shardings[0], mesh)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cache = random_cache(torch, dev, built, mesh)
    g = torch.Generator(device=dev).manual_seed(4)
    tok = torch.randint(1, cfg.vocab_size, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    kv = torch.full((B,), S - 8, dtype=torch.int32, device=dev)
    if built.in_shardings is not None:
        tspec = built.in_shardings[1]
        tok, kv = plans.block(tok, tspec, mesh), plans.block(kv, tspec, mesh)
    return cfg, built, params, cache, tok, kv


def serve_run(torch, dev, mesh, run, smoke):
    """``SERVE_STEPS`` placed steps of a serve part on ``mesh``: tokens,
    log-probs (gathered), step ms, the dense decode's launches and the
    collectives a step (``collectives.CALLS``)."""
    from repro_torch.distributed import collectives as COL
    from repro_torch.kernels import ops
    from repro_torch.launch import plans
    cfg, built, params, cache, tok, kv = serve_setup(torch, dev, mesh, run,
                                                     smoke)
    _, tspec, cspecs, _ = built.in_shardings
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    k = next(iter(sorted(cache)))
    out = {"tokens": [], "logprobs": [], "ms": [], "layers": cfg.num_layers,
           "batch": run[3], "mesh": list(run[5]), "f32": run[6],
           "cache_local_shape": list(cache[k].shape), "cache_leaf": k,
           "cache_rows": int(built.in_specs[2][k].shape[2]),
           "cache_gb_rank": sum(t.numel() * t.element_size()
                                for t in cache.values()) / 1e9}
    ops.reset_launch_counts()
    calls = dict(COL.CALLS)
    for _ in range(SERVE_STEPS):
        (tok, lp, cache), ms = timed(torch, dev, built.fn, params, tok, cache,
                                     kv)
        out["tokens"].append(plans.gather(tok, tspec, mesh).tolist())
        out["logprobs"].append(plans.gather(lp, tspec, mesh).tolist())
        out["ms"].append(ms)
        kv = kv + 1
    # the gathers of the outputs above are counted too: one a step each
    # for the token and the log-prob where they are split
    out["collectives_a_step"] = {n: (COL.CALLS[n] - calls.get(n, 0))
                                 / SERVE_STEPS for n in COL.CALLS
                                 if COL.CALLS[n] != calls.get(n, 0)}
    out.update(launches=ops.launch_counts(), peak_gb=peak_gb(torch, dev))
    if dev.type == "cuda":          # one more step, traced (not compared)
        out["profile"] = profile_call(torch, dev, lambda: built.fn(
            params, tok, cache, kv))
    return out


def one_card_serve(torch, dev, run, smoke):
    """A serve part's steps on one card, with the top-two logit gap a
    step."""
    from repro_torch.launch.mesh import make_local_mesh
    cfg, built, params, cache, tok, kv = serve_setup(
        torch, dev, make_local_mesh(), run, smoke)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"tokens": [], "logprobs": [], "top2_gap": [], "ms": []}
    for _ in range(SERVE_STEPS):
        (logits, cache), ms = timed(torch, dev, built.model.decode_step,
                                    params, tok, cache, kv)
        lf = logits.float()
        top = torch.topk(lf, 2, dim=-1).values
        tok = torch.argmax(lf, dim=-1)
        lp = torch.log_softmax(lf, dim=-1).gather(1, tok[:, None])[:, 0]
        tok = tok.to(torch.int32)
        out["tokens"].append(tok.tolist())
        out["logprobs"].append(lp.tolist())
        out["top2_gap"].append((top[:, 0] - top[:, 1]).tolist())
        out["ms"].append(ms)
        kv = kv + 1
    out["peak_gb"] = peak_gb(torch, dev)
    if dev.type == "cuda":
        out["profile"] = profile_call(torch, dev, lambda: built.fn(
            params, tok, cache, kv))
    return out


class RowParallelHalves:
    """While installed, the row-parallel products of the layers
    (``attn_output``'s ``wo`` over the heads, ``mlp``'s ``w_out`` over the
    FFN columns) are summed from two halves of their contracted dim, each
    half's product rounded to the compute dtype, then added in it: the
    partial sums the (2, 2) mesh's two model ranks form and all-reduce.
    One card's control of the mesh's bf16 rounding (no placement: the
    weights are whole)."""

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        from repro_torch.models import layers as L
        self.L, self.real = L, (L.attn_output, L.mlp)

        def attn_output(p, o):
            h = o.shape[2] // 2
            wo = p["wo"]
            return (torch.einsum("bshk,hkd->bsd", o[:, :, :h], wo[:h])
                    + torch.einsum("bshk,hkd->bsd", o[:, :, h:], wo[h:]))

        def mlp(p, x, act, gated):
            a = {"silu": F.silu, "relu2": lambda t: torch.square(F.relu(t)),
                 "gelu": lambda t: F.gelu(t, approximate="tanh")}[act](
                     x @ p["w_in"])
            if gated:
                a = a * (x @ p["w_gate"])
            h, w = a.shape[-1] // 2, p["w_out"]
            return a[..., :h] @ w[:h] + a[..., h:] @ w[h:]
        L.attn_output, L.mlp = attn_output, mlp
        return self

    def __exit__(self, *exc):
        self.L.attn_output, self.L.mlp = self.real


def write(name, obj):
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.json").write_text(json.dumps(obj, indent=1))
    print(json.dumps({"part": name, **{k: v for k, v in obj.items()
                                        if k != "runs"}}), flush=True)


def part_mesh(args, torch):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_compat_mesh
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != 4:
        raise SystemExit(f"mesh_run mesh: needs 4 ranks, got {world}")
    if args.device == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev,
                                timeout=datetime.timedelta(seconds=300))
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo",
                                timeout=datetime.timedelta(seconds=300))
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        mesh = make_compat_mesh((2, 2), ("data", "model"), dev.type)
        S = 64 if args.smoke else TRAIN[2]
        for depth in ((2,) if args.smoke else TRAIN_DEPTHS):
            cfg = config(torch, TRAIN[0], args.smoke, depth)
            runs[f"train_{depth}"] = train_run(torch, dev, mesh, cfg,
                                               args.batch, S)
            dist.barrier()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        runs.update(f32_runs(torch, dev, mesh, args.smoke))
        dist.barrier()
        meshes = {}
        for name, run in SERVE_RUNS.items():
            if run[5] not in meshes:
                meshes[run[5]] = make_compat_mesh(run[5], ("data", "model"),
                                                  dev.type)
            runs[name] = serve_run(torch, dev, meshes[run[5]], run,
                                   args.smoke)
            dist.barrier()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    write(f"mesh_rank{rank}", {"rank": rank, "device": str(dev),
                               "card": card() if dev.type == "cuda" else "cpu",
                               "runs": runs})


def part_one_card(args, torch):
    from repro_torch.launch.mesh import make_local_mesh
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    depth = 2 if args.smoke else TRAIN_DEPTHS[0]
    runs = {}
    cfg = config(torch, TRAIN[0], args.smoke, depth)
    S = 64 if args.smoke else TRAIN[2]
    runs[f"train_{depth}"] = train_run(torch, dev, make_local_mesh(), cfg,
                                       args.batch, S)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with RowParallelHalves():
        runs[f"train_{depth}_halves"] = train_run(
            torch, dev, make_local_mesh(), cfg, args.batch, S)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    runs.update(f32_runs(torch, dev, make_local_mesh(), args.smoke))
    for run in SERVE_RUNS.values():
        key = one_card_key(run)
        if key not in runs:
            runs[key] = one_card_serve(torch, dev, run, args.smoke)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    write("one_card", {"device": str(dev),
                       "card": card() if dev.type == "cuda" else "cpu",
                       "runs": runs})


def rel_gaps(a, b):
    return {k: [abs(x - y) / abs(y) for x, y in zip(a[k], b[k])]
            for k in ("loss", "grad_norm")}


def first_partings(mesh_sv, one_sv):
    """Per slot: the first step whose token is apart from one card's (and
    one card's top-two logit gap there), and the largest log-prob gap
    over the steps before it."""
    out = []
    steps = len(one_sv["tokens"])
    for j in range(len(one_sv["tokens"][0])):
        first = next((i for i in range(steps) if mesh_sv["tokens"][i][j]
                      != one_sv["tokens"][i][j]), None)
        upto = steps if first is None else first
        out.append({"slot": j, "first_step": first,
                    "top2_gap": (None if first is None
                                 else one_sv["top2_gap"][first][j]),
                    "logprob_gap_before": max(
                        (abs(mesh_sv["logprobs"][i][j]
                             - one_sv["logprobs"][i][j])
                         for i in range(upto)), default=None)})
    return out


def compare_train(ranks, one):
    """The bf16 and f32 train parts against one card, and the bf16
    control's gaps beside the mesh's; a miss where a part is absent."""
    depth = next((k for k in one["runs"] if k.startswith("train_")
                  and k not in F32_RUNS and not k.endswith("_halves")), None)
    want = [depth, *F32_RUNS]
    absent = [k for k in want if k is None or k not in one["runs"]
              or any(k not in r["runs"] for r in ranks)]
    if absent or f"{depth}_halves" not in one["runs"]:
        return {"train_parts_absent": absent or [f"{depth}_halves"]}, False
    mesh_tr = [r["runs"][depth] for r in ranks]
    ref = one["runs"][depth]
    same = all(r["loss"] == mesh_tr[0]["loss"]
               and r["grad_norm"] == mesh_tr[0]["grad_norm"] for r in mesh_tr)
    gaps = rel_gaps(mesh_tr[0], ref)
    train_ok = (same and max(gaps["loss"]) <= TRAIN_TOL["loss_rel"]
                and max(gaps["grad_norm"]) <= TRAIN_TOL["grad_norm_rel"]
                and all(math.isfinite(x) for x in mesh_tr[0]["loss"]))
    f32 = {}
    for k in F32_RUNS:
        m = [r["runs"][k] for r in ranks]
        g = rel_gaps(m[0], one["runs"][k])
        f32[k] = {
            "ranks_agree": all(r["loss"] == m[0]["loss"] and r["grad_norm"]
                               == m[0]["grad_norm"] for r in m),
            "mesh": {q: m[0][q] for q in ("loss", "grad_norm")},
            "one_card": {q: one["runs"][k][q] for q in ("loss", "grad_norm")},
            "rel_gap": g, "batch": m[0]["batch"], "seq": m[0]["seq"],
            "mesh_ms": [r["ms"] for r in m],
            "mesh_peak_gb": [r["peak_gb"] for r in m],
            "one_card_ms": one["runs"][k]["ms"],
            "one_card_peak_gb": one["runs"][k]["peak_gb"]}
        f32[k]["ok"] = f32[k]["ranks_agree"] and all(
            x <= tol for q in ("loss", "grad_norm")
            for x, tol in zip(g[q], F32_TOL[f"{q}_rel"]))
    full = [k for k in ranks[0]["runs"] if k.startswith("train_")
            and k != depth and k not in F32_RUNS]
    halves = one["runs"][f"{depth}_halves"]
    out = {
        "tol": TRAIN_TOL,
        "train": {"depth": depth, "ranks_agree": same,
                  "mesh": {k: mesh_tr[0][k] for k in ("loss", "grad_norm")},
                  "one_card": {k: ref[k] for k in ("loss", "grad_norm")},
                  "rel_gap": gaps, "ok": train_ok,
                  "mesh_ms": [r["ms"] for r in mesh_tr],
                  "mesh_peak_gb": [r["peak_gb"] for r in mesh_tr],
                  "one_card_ms": ref["ms"], "one_card_peak_gb":
                  ref["peak_gb"], "local_wq": mesh_tr[0]["local_wq"],
                  "local_embed": mesh_tr[0]["local_embed"]},
        # one card with the row-parallel partial sums rounded as the mesh
        # rounds them: its gap from the plain one-card run beside the
        # mesh's (reported; the question it answers is PERF.md's)
        "bf16_halves_control": {
            "loss": halves["loss"], "grad_norm": halves["grad_norm"],
            "rel_gap_to_one_card": rel_gaps(halves, ref),
            "rel_gap_to_mesh": rel_gaps(halves, mesh_tr[0]),
            "mesh_rel_gap_to_one_card": gaps},
        "f32_tol": F32_TOL, "train_f32": f32,
        "train_full_depth": {k: {"peak_gb": [r["runs"][k]["peak_gb"]
                                             for r in ranks],
                                 "ms": [r["runs"][k]["ms"] for r in ranks],
                                 "update_ms_median": statistics.median(
                                     r["runs"][k]["ms"][-1] for r in ranks),
                                 "loss": ranks[0]["runs"][k]["loss"],
                                 "grad_norm": ranks[0]["runs"][k]["grad_norm"]}
                             for k in full}}
    return out, train_ok and all(v["ok"] for v in f32.values())


def compare_serve(sv, one_sv):
    """A serve part's ranks against its one-card run: tokens equal, or
    each slot's first parting at a near tie there (``NEAR_TIE``; in f32
    ``F32_NEAR_TIE``, and the log-probs before it within
    ``SERVE_F32_TOL``); the ranks agree."""
    partings = first_partings(sv[0], one_sv)
    before = [p["logprob_gap_before"] for p in partings
              if p["logprob_gap_before"] is not None]
    f32 = sv[0]["f32"]
    tie = F32_NEAR_TIE if f32 else NEAR_TIE
    out = {"tokens_equal": all(p["first_step"] is None for p in partings),
           "f32": f32, "near_tie": tie, "first_partings": partings,
           # the rounding's scale: the largest gap between the two sides'
           # log-probs of one token (any slot, before it parts)
           "logprob_gap_max": max(before, default=None),
           "partings_at_near_ties": all(
               p["first_step"] is None or p["top2_gap"] < tie
               for p in partings),
           "ranks_agree": all(s["tokens"] == sv[0]["tokens"] for s in sv),
           "mesh": sv[0]["mesh"], "layers": sv[0]["layers"],
           "batch": sv[0]["batch"],
           "mesh_step_ms": [s["ms"] for s in sv],
           "mesh_step_ms_median": statistics.median(
               statistics.median(s["ms"][1:]) for s in sv),
           "one_card_step_ms": one_sv["ms"],
           "one_card_step_ms_median": statistics.median(one_sv["ms"][1:]),
           "cache_local_shape": sv[0]["cache_local_shape"],
           "cache_leaf": sv[0]["cache_leaf"],
           "cache_rows": sv[0]["cache_rows"],
           "cache_gb_rank": sv[0]["cache_gb_rank"],
           "collectives_a_step": sv[0]["collectives_a_step"],
           "launches": sv[0]["launches"],
           "mesh_peak_gb": [s["peak_gb"] for s in sv],
           "one_card_peak_gb": one_sv["peak_gb"],
           "mesh_profile": [s.get("profile") for s in sv],
           "one_card_profile": one_sv.get("profile")}
    out["ok"] = out["partings_at_near_ties"] and out["ranks_agree"]
    if f32:
        out["logprob_tol"] = SERVE_F32_TOL
        out["ok"] = out["ok"] and (out["logprob_gap_max"] or 0.0) \
            <= SERVE_F32_TOL
    return out


def part_compare(args):
    ranks = [json.loads((OUT / f"mesh_rank{r}.json").read_text())
             for r in range(4)]
    one = json.loads((OUT / "one_card.json").read_text())
    summary, ok = compare_train(ranks, one)
    summary["card"] = ranks[0]["card"]
    for name, run in SERVE_RUNS.items():
        summary[name] = compare_serve([r["runs"][name] for r in ranks],
                                      one["runs"][one_card_key(run)])
        ok = ok and summary[name]["ok"]
    summary["ok"] = ok
    write("compare", summary)
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("part", choices=("mesh", "one_card", "compare"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="narrow widths in f32 (the CPU rehearsal)")
    # train_4k's batch cut to 4: one card ran out of its 80 GB at 16 (8
    # layers, 4 microbatches of 4 rows: 53.4 GB held and 15.6 GB asked
    # for in the final softcap's tanh)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    if args.part == "compare":
        return part_compare(args)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mesh_run: no CUDA device", file=sys.stderr)
        return 2
    if args.device == "cpu":
        torch.set_num_threads(1)
    {"mesh": part_mesh, "one_card": part_one_card}[args.part](args, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
