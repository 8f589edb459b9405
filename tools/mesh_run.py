"""The dense and MoE families' placed launch steps across four cards,
against the same steps on one card.

    python3 tools/mesh_run.py one_card
    torchrun --standalone --nproc-per-node 4 tools/mesh_run.py mesh
    python3 tools/mesh_run.py compare

(``one_card`` first: the mesh's forced parts read its routings.)

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
  the 8-layer bf16 steps again with every sum of the collectives carried
  in f32 (``F32Collectives``: ``train_8_f32_sums``) and with the
  row-parallel products' partials formed in f32 too
  (``train_8_f32_partials``);
* Granite-MoE-3B-A800M's train_4k plan at 8 layers (``MOE_TRAIN_RUNS``:
  bf16 at B 8, S 4096, the batch replicated over ``data``; f32 at B 16,
  S 1024, the batch split over ``data``), the experts' layer over
  ``all_to_all_single``, with a traced third step;
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
  gathered), and Qwen1.5-110B's at 2 layers again in f32; Qwen3-0.6B's
  decode_32k again in f32 at 8 layers on (1, 4); Granite-MoE's
  ``seqshard`` decode_32k at its 32 layers, B 16, and Qwen3-MoE's
  ``decode_2d`` at 4 layers, B 8, on (2, 2): tokens, log-probs, step ms,
  the dense decode's launches and the collectives a step;
* the routing-forced controls (``FORCED_RUNS``): Granite-MoE's f32 train
  part and the two MoE bf16 serve parts again, each top-k routing
  replaced by one card's (``ForcedRouting``), so that what is left
  between the two sides is the arithmetic's rounding.

``one_card`` runs the 8-layer Gemma2 steps (bf16, the f32 runs and the
bf16 control ``train_8_halves``: the row-parallel products, ``wo`` and
``w_out``, summed from two halves each rounded to bf16, as the (2, 2)
mesh forms them), Granite-MoE's train parts with its MoE layers run
block by block as the mesh's expert-parallel blocks (``BlockedMoE``: a
block's capacity, drops and router losses are its own) and each serve
run on card 0 from the same seeds on ``make_local_mesh()`` (the serve
steps with the top-two logit gap at every step); ``compare`` holds the
four-card loss and grad norm to one card's (``TRAIN_TOL`` in bf16,
``F32_TOL`` in f32: in f32 the two differ only in the order of their
sums, so a gap beyond it is the placement's), reports the f32-sum runs'
gaps beside the bf16 part's,
and each slot's first token apart from one card's to a near tie there
(``NEAR_TIE``; its later tokens follow a different input; in f32
``F32_NEAR_TIE``, and the log-probs before it within ``SERVE_F32_TOL``
of one card's), reports the
control's gaps beside the mesh's and one traced serve step a rank, and
exits 1 on any miss, an absent part included (``--parts`` runs some
parts of ``mesh`` or ``one_card`` alone).  Inputs and weights come
from seeds (Gemma2's ``wo`` and ``w_out`` scaled 8x at init, as
``chip_smoke.LAUNCH_SCALES``).  Each part writes
``chiprun_out/mesh_run/<part>*.json``; ``--device cpu --smoke`` runs the
same at narrow widths on gloo (the CPU rehearsal).
"""
import argparse
import contextlib
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
# Granite-MoE-3B-A800M's train_4k plan (tp, FSDP, SP, remat, 4
# microbatches; the experts' layer over all_to_all) at 8 of 32 layers:
# name -> (batch, seq, f32).  bf16 at B 8, not 4: 4 rows give its 4
# microbatches one row each, which the 2 data ranks' blocks cannot split
# (the reference's shard_map refuses it too); f32 at B 16, S 1024, the
# batch split over data
MOE_TRAIN = ("granite_moe_3b_a800m", "train_4k", 8)
MOE_TRAIN_RUNS = {"moe_train_8": (8, 4096, False),
                  "moe_train_8_f32_b16": (16, 1024, True)}
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
    # Qwen3-0.6B's decode_32k in f32 at 8 of 28 layers (17.4 GB of f32
    # cache on one card): the witness of the bf16 part's parting
    "serve_f32": ("qwen3_0_6b", "decode_32k", 32_768, 8, 8, (1, 4), True),
    # the MoE family: Granite-MoE's seqshard decode (slots over data, the
    # rows over model, the whole batch's dispatch over the data ranks) at
    # its 32 layers, B 16 (34.9 GB of cache on one card), and
    # Qwen3-MoE's decode_2d (the experts over model, d over data) at 4 of
    # 94 layers, B 8
    "serve_granite_decode_32k": ("granite_moe_3b_a800m", "decode_32k",
                                 32_768, 16, None, (2, 2), False),
    "serve_qwen3_moe_decode_2d": ("qwen3_moe_235b_a22b", "decode_32k",
                                  32_768, 8, 4, (2, 2), False),
    # Granite-MoE's serve part in f32 at 8 layers (17.4 GB of f32 cache
    # on one card): the placement against one card without bf16's
    # rounding, which moves the routers' top-k choices (Qwen3-MoE's G 16
    # has no f32 instantiation of the dense decode)
    "serve_granite_decode_32k_f32": ("granite_moe_3b_a800m", "decode_32k",
                                     32_768, 16, 8, (2, 2), True),
}
# the routing-forced controls: part -> the part it repeats on the mesh
# with one card's routings (``ForcedRouting``), held as that part is
FORCED_RUNS = {"moe_train_8_f32_b16_forced": "moe_train_8_f32_b16",
               "serve_granite_decode_32k_forced": "serve_granite_decode_32k",
               "serve_qwen3_moe_decode_2d_forced":
                   "serve_qwen3_moe_decode_2d"}
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
# the bf16 8-layer Gemma2 steps on the mesh with every sum of the
# collectives carried in f32 (F32Collectives), and with the row-parallel
# partials formed in f32 too: name -> partials
F32_SUM_RUNS = {"train_8_f32_sums": False, "train_8_f32_partials": True}
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


def f32_runs(torch, dev, mesh, smoke, args):
    """The 8-layer Gemma2 steps in f32 on ``mesh`` (``F32_RUNS``)."""
    runs = {}
    for name, (B, S) in F32_RUNS.items():
        if not selected(args, name):
            continue
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


def train_run(torch, dev, mesh, cfg, B, S, arch=TRAIN[0], trace=False,
              record=None):
    """``TRAIN_STEPS`` steps of ``arch``'s train_4k plan (Gemma2's by
    default) on ``mesh`` (placed on a ``DeviceMesh``): loss, grad norm,
    ms, peak GB and the collectives a step; with ``trace`` one more step
    traced (not compared); ``record`` (a ``RoutingRecord`` or
    ``ForcedRouting``) installed for the compared steps."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives as COL
    from repro_torch.launch import plans, steps, train
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    plan = plans.get_plan(arch, TRAIN[1])
    built = steps.build_train_step(cfg, ShapeConfig(TRAIN[1], S, B, "train"),
                                   plan, mesh, False, device=dev)
    params = built.model.init_params(torch.Generator(device=dev)
                                     .manual_seed(0))
    if arch == TRAIN[0]:
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
    calls = dict(COL.CALLS)
    for i in range(TRAIN_STEPS):
        if record is not None:
            record.step = i
        with record if record is not None else contextlib.nullcontext():
            (params, opt, m), ms = timed(torch, dev, built.fn, params, opt,
                                         batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["ms"].append(ms)
    out.update(peak_gb=peak_gb(torch, dev), layers=cfg.num_layers, batch=B,
               seq=S, microbatches=plan.microbatches,
               local_wq=list(params["layers"]["attn"]["wq"].shape),
               local_embed=list(params["embed"].shape),
               collectives_a_step={n: (COL.CALLS[n] - calls.get(n, 0))
                                   / TRAIN_STEPS for n in COL.CALLS
                                   if COL.CALLS[n] != calls.get(n, 0)})
    if cfg.family == "moe":
        out["local_w_in"] = list(params["layers"]["mlp"]["w_in"].shape)
    if trace and dev.type == "cuda":
        out["profile"] = profile_call(torch, dev, lambda: built.fn(
            params, opt, batch))
    return out


def moe_train_runs(torch, dev, mesh, smoke, args, one_card=False):
    """Granite-MoE's train parts (``MOE_TRAIN_RUNS``) on ``mesh``; on one
    card (``one_card``) its MoE layers run block by block as the (2, 2)
    mesh's expert-parallel blocks (``BlockedMoE``).  Each compared step's
    routings are kept (``RoutingRecord``) in ``routing_<part>_<side>.pt``.
    On the mesh the forced parts (``FORCED_RUNS``) follow: their base
    part again with one card's routings (``ForcedRouting``)."""
    runs = {}
    side = "one_card" if one_card else f"rank{os.environ.get('RANK', 0)}"
    for name, (B, S, f32) in MOE_TRAIN_RUNS.items():
        if not selected(args, name):
            continue
        cfg = config(torch, MOE_TRAIN[0], smoke,
                     2 if smoke else MOE_TRAIN[2], f32=f32)
        rec = RoutingRecord()
        with BlockedMoE((2, 2)) if one_card else contextlib.nullcontext():
            runs[name] = train_run(torch, dev, mesh, cfg, B,
                                   64 if smoke else S,
                                   arch=MOE_TRAIN[0], trace=True,
                                   record=rec)
        save_routing(torch, rec, f"{name}_{side}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for name, base in FORCED_RUNS.items():
        if one_card or base not in MOE_TRAIN_RUNS \
                or not selected(args, name):
            continue
        B, S, f32 = MOE_TRAIN_RUNS[base]
        cfg = config(torch, MOE_TRAIN[0], smoke,
                     2 if smoke else MOE_TRAIN[2], f32=f32)
        forced = ForcedRouting(OUT / f"routing_{base}_one_card.pt")
        runs[name] = train_run(torch, dev, mesh, cfg, B, 64 if smoke else S,
                               arch=MOE_TRAIN[0], record=forced)
        runs[name]["forced"] = forced.stats()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return runs


def save_routing(torch, rec, name):
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(rec.calls, OUT / f"routing_{name}.pt")


class RoutingRecord:
    """While installed, each top-k routing of ``models/moe.py`` keeps, on
    the host, its experts ``idx`` (T, k; uint8), at step 0 each token's
    margin (the k-th largest router probability less the (k + 1)-th: a
    token whose margin is below the rounding between two runs may be
    routed differently by them; None at later steps, to keep the files
    small) and ``step``, the step it belongs to."""

    def __init__(self):
        self.calls, self.step = [], 0

    def __enter__(self):
        import torch
        from repro_torch.models import moe as MOE
        self.MOE, real = MOE, MOE.top_k_lowest_first
        self.real = real

        def recorded(x, k):
            vals, idx = real(x, k + 1)
            margin = (vals[..., k - 1] - vals[..., k]).detach().cpu() \
                if self.step == 0 else None
            self.calls.append((idx[..., :k].to(torch.uint8).cpu(), margin,
                               self.step))
            return vals[..., :k], idx[..., :k]
        MOE.top_k_lowest_first = recorded
        return self

    def __exit__(self, *exc):
        self.MOE.top_k_lowest_first = self.real


class ForcedRouting:
    """While installed, each top-k routing of ``models/moe.py`` takes one
    card's experts instead of its own (the control that removes routing
    flips): of one card's routings of the same ``step``
    (``RoutingRecord``), cut into blocks of this call's T tokens, the
    block whose experts (in their order, which orders the slots) agree
    with this call's own at the most tokens; the gates are this call's
    probabilities at those experts.  ``overridden`` counts the tokens
    whose own experts differed, ``worst`` the most in one call."""

    def __init__(self, path):
        self.path = path
        self.step = self.calls = self.overridden = self.worst = 0

    def __enter__(self):
        import torch
        from repro_torch.models import moe as MOE
        self.MOE, real = MOE, MOE.top_k_lowest_first
        self.real = real
        one = torch.load(self.path)
        blocks = {}

        def candidates(T, dev):
            if (T, self.step) not in blocks:
                cut = [b for idx, _, step in one if step == self.step
                       and idx.shape[0] % T == 0 for b in idx.split(T)]
                if not cut:
                    raise SystemExit(f"ForcedRouting: no routing of {T} "
                                     f"tokens at step {self.step} in "
                                     f"{self.path}")
                blocks[T, self.step] = torch.stack(cut).to(dev).long()
            return blocks[T, self.step]

        def forced(x, k):
            _, idx = real(x, k)
            orig = candidates(idx.shape[0], idx.device)
            bad = (orig != idx).any(-1).sum(-1)
            j = int(bad.argmin())
            n = int(bad[j])
            self.calls += 1
            self.overridden += n
            self.worst = max(self.worst, n)
            f = orig[j]
            return x.gather(-1, f), f
        MOE.top_k_lowest_first = forced
        return self

    def __exit__(self, *exc):
        self.MOE.top_k_lowest_first = self.real

    def stats(self):
        return {"calls": self.calls, "tokens_overridden": self.overridden,
                "worst_call_overridden": self.worst}


def routing_gaps(torch, name):
    """The first step's routings on the mesh's ranks against one card's
    (``RoutingRecord``): each rank's call matched to the one-card call
    (the same number of tokens) whose experts agree at the most tokens;
    the tokens routed differently, and one card's margins at them beside
    the smallest margin overall."""
    one = [c[:2] for c in torch.load(OUT / f"routing_{name}_one_card.pt")
           if c[2] == 0]
    differ, margins, calls = 0, [], 0
    for r in range(4):
        path = OUT / f"routing_{name}_rank{r}.pt"
        if not path.exists():
            return None
        for idx, _, step in torch.load(path):
            if step:
                continue
            best = None
            for oidx, omargin in one:
                if oidx.shape != idx.shape:
                    continue
                bad = (oidx.sort(-1).values != idx.sort(-1).values).any(-1)
                if best is None or int(bad.sum()) < int(best[0].sum()):
                    best = (bad, omargin)
            calls += 1
            differ += int(best[0].sum())
            margins += best[1][best[0]].tolist()
    every = torch.cat([m.flatten() for _, m in one])
    return {"calls": calls, "tokens_routed_differently": differ,
            "one_card_margins_there": sorted(margins)[:50],
            "max_margin_there": max(margins, default=None),
            "tokens_a_call": int(one[0][0].shape[0]),
            "one_card_min_margin": float(every.detach().min()),
            "one_card_margins_below_1e-6": int((every < 1e-6).sum()),
            "one_card_margins_below_1e-5": int((every < 1e-5).sum()),
            "one_card_routings": int(every.numel())}


class BlockedMoE:
    """While installed, ``moe.moe_mlp_dense`` runs each block of its x
    that the expert-parallel layer's ``shard_map`` blocks make on a
    ``(n_data, n_model)`` mesh (B cut n_data ways, S n_model ways) as a
    call of its own: each block's capacity, drops and router losses (their
    mean over the blocks), as the mesh computes them; the experts' FFN is
    a token's own, so one card then runs the mesh's arithmetic."""

    def __init__(self, blocks):
        self.blocks = blocks

    def __enter__(self):
        import torch
        from repro_torch.models import moe as MOE
        self.MOE, real = MOE, MOE.moe_mlp_dense
        self.real = real
        nd, nm = self.blocks

        def blocked(p, cfg, x, with_aux=True, **kw):
            ys, auxes = [], []
            for rows in x.chunk(nd, 0):
                part = []
                for xb in rows.chunk(nm, 1):
                    y, a = real(p, cfg, xb, with_aux, **kw)
                    part.append(y)
                    auxes.append(a)
                ys.append(torch.cat(part, 1))
            aux = None if not with_aux else {
                k: torch.stack([a[k] for a in auxes]).mean(0)
                for k in auxes[0]}
            return torch.cat(ys, 0), aux
        MOE.moe_mlp_dense = blocked
        return self

    def __exit__(self, *exc):
        self.MOE.moe_mlp_dense = self.real


class F32Collectives:
    """While installed, every sum of ``distributed/collectives.py`` (the
    all-reduces, ``sum_grad``'s backward, the gradient syncs and the
    reduce-scatters, ``sum_over`` and ``_reduce_scatter`` beneath them) is
    carried in f32: its operand cast to f32 before the sum, the result cast
    back after.  ``partials``: the row-parallel products (``wo``,
    ``w_out``) also form their partial sums in f32, so that what reaches
    the sum is not rounded to bf16 first."""

    def __init__(self, partials=False):
        self.partials = partials

    def __enter__(self):
        import torch
        from repro_torch.distributed import collectives as COL
        from repro_torch.distributed import sharding as SH
        from repro_torch.models import layers as L
        self.COL, self.L = COL, L
        self.real = (COL.sum_over, COL._reduce_scatter, L.attn_output, L.mlp)
        sum_over, reduce_scatter, attn_output, mlp = self.real
        COL.sum_over = lambda x, groups: sum_over(x.float(), groups).to(
            x.dtype)
        COL._reduce_scatter = lambda x, group, dim: reduce_scatter(
            x.float(), group, dim).to(x.dtype)
        if not self.partials:
            return self

        def out_f32(a, w, spec, x_dtype):
            out = torch.einsum(spec, a.float(), w.float())
            return SH.logical_constraint(
                out, ("batch", "seq", "embed"),
                partial=SH.model_axis() is not None).to(x_dtype)

        def attn_output_f32(p, o):
            wo = SH.weight(p["wo"], ("layers", "attn", "wo"), split=0,
                           embed=2)
            return out_f32(o, wo, "bshk,hkd->bsd", o.dtype)

        def mlp_f32(p, x, act, gated):
            path = ("layers", "mlp")
            F = torch.nn.functional
            h = SH.contract(x @ SH.weight(p["w_in"], path + ("w_in",),
                                          split=1, embed=0))
            a = {"silu": F.silu, "relu2": lambda t: torch.square(F.relu(t)),
                 "gelu": lambda t: F.gelu(t, approximate="tanh")}[act](h)
            if gated:
                a = a * SH.contract(x @ SH.weight(
                    p["w_gate"], path + ("w_gate",), split=1, embed=0))
            w = SH.weight(p["w_out"], path + ("w_out",), split=0, embed=1)
            return out_f32(a, w, "bsf,fd->bsd", x.dtype)
        L.attn_output, L.mlp = attn_output_f32, mlp_f32
        return self

    def __exit__(self, *exc):
        COL, L = self.COL, self.L
        (COL.sum_over, COL._reduce_scatter, L.attn_output,
         L.mlp) = self.real


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
            # NCCL's all-to-all is grouped send/receive
            "all_to_all_device_ms": sum(
                r.self_device_time_total for r in cuda
                if "sendrecv" in r.key.lower()) / 1e3,
            "all_to_all_host_ms": sum(
                r.self_cpu_time_total for r in rows
                if r.device_type == torch.autograd.DeviceType.CPU
                and ("alltoall" in r.key.lower()
                     or "all_to_all" in r.key.lower())) / 1e3,
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


def serve_run(torch, dev, mesh, run, smoke, record=None):
    """``SERVE_STEPS`` placed steps of a serve part on ``mesh``: tokens,
    log-probs (gathered), step ms, the dense decode's launches and the
    collectives a step (``collectives.CALLS``); ``record`` (a
    ``ForcedRouting``) installed for those steps."""
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
    for i in range(SERVE_STEPS):
        if record is not None:
            record.step = i
        with record if record is not None else contextlib.nullcontext():
            (tok, lp, cache), ms = timed(torch, dev, built.fn, params, tok,
                                         cache, kv)
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
    step; an MoE model's routings kept (``RoutingRecord``) in
    ``routing_<one_card_key>_one_card.pt``."""
    from repro_torch.launch.mesh import make_local_mesh
    cfg, built, params, cache, tok, kv = serve_setup(
        torch, dev, make_local_mesh(), run, smoke)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"tokens": [], "logprobs": [], "top2_gap": [], "ms": []}
    rec = RoutingRecord()
    for i in range(SERVE_STEPS):
        rec.step = i
        with rec if cfg.family == "moe" else contextlib.nullcontext():
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
    if rec.calls:
        save_routing(torch, rec, f"{one_card_key(run)}_one_card")
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


def write(name, obj, quiet=False):
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.json").write_text(json.dumps(obj, indent=1))
    if not quiet:
        print(json.dumps({"part": name, **{k: v for k, v in obj.items()
                                            if k != "runs"}}), flush=True)


def selected(args, name: str) -> bool:
    """A part runs unless ``--parts`` names others (``compare`` holds
    every part and fails where one is absent)."""
    return not args.parts or name in args.parts


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
    head = {"rank": rank, "device": str(dev),
            "card": card() if dev.type == "cuda" else "cpu"}

    def settle():
        # each part's results kept as it ends: a later failure loses only
        # its own
        write(f"mesh_rank{rank}", dict(head, runs=runs), quiet=True)
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    try:
        mesh = make_compat_mesh((2, 2), ("data", "model"), dev.type)
        S = 64 if args.smoke else TRAIN[2]
        for depth in ((2,) if args.smoke else TRAIN_DEPTHS):
            if selected(args, f"train_{depth}"):
                cfg = config(torch, TRAIN[0], args.smoke, depth)
                runs[f"train_{depth}"] = train_run(torch, dev, mesh, cfg,
                                                   args.batch, S)
                settle()
        runs.update(f32_runs(torch, dev, mesh, args.smoke, args))
        settle()
        # the bf16 8-layer steps again with every sum carried in f32, then
        # with the row-parallel partials in f32 too
        depth = 2 if args.smoke else TRAIN_DEPTHS[0]
        cfg = config(torch, TRAIN[0], args.smoke, depth)
        for name, partials in F32_SUM_RUNS.items():
            if selected(args, name):
                with F32Collectives(partials):
                    runs[name] = train_run(torch, dev, mesh, cfg, args.batch,
                                           S)
                settle()
        runs.update(moe_train_runs(torch, dev, mesh, args.smoke, args))
        settle()
        meshes = {}
        for name, run in SERVE_RUNS.items():
            if not selected(args, name):
                continue
            if run[5] not in meshes:
                meshes[run[5]] = make_compat_mesh(run[5], ("data", "model"),
                                                  dev.type)
            runs[name] = serve_run(torch, dev, meshes[run[5]], run,
                                   args.smoke)
            settle()
        for name, base in FORCED_RUNS.items():
            if base not in SERVE_RUNS or not selected(args, name):
                continue
            run = SERVE_RUNS[base]
            if run[5] not in meshes:
                meshes[run[5]] = make_compat_mesh(run[5], ("data", "model"),
                                                  dev.type)
            forced = ForcedRouting(
                OUT / f"routing_{one_card_key(run)}_one_card.pt")
            runs[name] = serve_run(torch, dev, meshes[run[5]], run,
                                   args.smoke, record=forced)
            runs[name]["forced"] = forced.stats()
            settle()
    finally:
        dist.destroy_process_group()
    write(f"mesh_rank{rank}", dict(head, runs=runs))


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
    if selected(args, f"train_{depth}"):
        runs[f"train_{depth}"] = train_run(torch, dev, make_local_mesh(),
                                           cfg, args.batch, S)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        with RowParallelHalves():
            runs[f"train_{depth}_halves"] = train_run(
                torch, dev, make_local_mesh(), cfg, args.batch, S)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    runs.update(f32_runs(torch, dev, make_local_mesh(), args.smoke, args))
    runs.update(moe_train_runs(torch, dev, make_local_mesh(), args.smoke,
                               args, one_card=True))
    head = {"device": str(dev),
            "card": card() if dev.type == "cuda" else "cpu"}
    for name, run in SERVE_RUNS.items():
        key = one_card_key(run)
        if selected(args, name) and key not in runs:
            runs[key] = one_card_serve(torch, dev, run, args.smoke)
            write("one_card", dict(head, runs=runs), quiet=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    write("one_card", dict(head, runs=runs))


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
    # the bf16 steps with the sums in f32: their gap to one card beside
    # the bf16 part's (reported; the fault's evidence, ROADMAP.md)
    out["f32_sums"] = {}
    for k in F32_SUM_RUNS:
        if all(k in r["runs"] for r in ranks):
            m = [r["runs"][k] for r in ranks]
            out["f32_sums"][k] = {
                "ranks_agree": all(r["loss"] == m[0]["loss"] and r["grad_norm"]
                                   == m[0]["grad_norm"] for r in m),
                "mesh": {q: m[0][q] for q in ("loss", "grad_norm")},
                "rel_gap_to_one_card": rel_gaps(m[0], ref),
                "rel_gap_to_bf16_mesh": rel_gaps(m[0], mesh_tr[0]),
                "within_train_tol": all(
                    x <= TRAIN_TOL[f"{q}_rel"] for q in ("loss", "grad_norm")
                    for x in rel_gaps(m[0], ref)[q]),
                "mesh_ms": [r["ms"] for r in m]}
    return out, train_ok and all(v["ok"] for v in f32.values())


def compare_moe_train(ranks, one):
    """Granite-MoE's train parts, and their forced parts
    (``FORCED_RUNS``), against one card running the mesh's blocks
    (``TRAIN_TOL`` in bf16, ``F32_TOL`` in f32), with each rank's peak
    GB, step ms, collectives a step and traced all-to-all ms; a miss where
    a part is absent."""
    out, ok = {}, True
    parts = [(k, k) for k in MOE_TRAIN_RUNS] + [
        (k, base) for k, base in FORCED_RUNS.items()
        if base in MOE_TRAIN_RUNS]
    for k, base in parts:
        f32 = MOE_TRAIN_RUNS[base][2]
        if base not in one["runs"] or any(k not in r["runs"] for r in ranks):
            out[k] = {"absent": True}
            ok = False
            continue
        m = [r["runs"][k] for r in ranks]
        g = rel_gaps(m[0], one["runs"][base])
        if f32:
            within = all(x <= tol for q in ("loss", "grad_norm")
                         for x, tol in zip(g[q], F32_TOL[f"{q}_rel"]))
        else:
            within = all(x <= TRAIN_TOL[f"{q}_rel"]
                         for q in ("loss", "grad_norm") for x in g[q])
        agree = all(r["loss"] == m[0]["loss"] and r["grad_norm"]
                    == m[0]["grad_norm"] for r in m)
        prof = [r.get("profile") or {} for r in m]
        out[k] = {"f32": f32, "tol": F32_TOL if f32 else TRAIN_TOL,
                  "batch": m[0]["batch"], "seq": m[0]["seq"],
                  "layers": m[0]["layers"], "ranks_agree": agree,
                  "mesh": {q: m[0][q] for q in ("loss", "grad_norm")},
                  "one_card": {q: one["runs"][base][q]
                               for q in ("loss", "grad_norm")},
                  "rel_gap": g, "ok": agree and within,
                  "local_w_in": m[0].get("local_w_in"),
                  "mesh_ms": [r["ms"] for r in m],
                  "mesh_peak_gb": [r["peak_gb"] for r in m],
                  "one_card_ms": one["runs"][base]["ms"],
                  "one_card_peak_gb": one["runs"][base]["peak_gb"],
                  "collectives_a_step": m[0]["collectives_a_step"],
                  "all_to_all_device_ms_traced_step": [
                      p.get("all_to_all_device_ms") for p in prof],
                  "all_to_all_host_ms_traced_step": [
                      p.get("all_to_all_host_ms") for p in prof],
                  "mesh_profile": prof,
                  "one_card_profile": one["runs"][base].get("profile")}
        if k == base:
            out[k]["routing"] = routing_gaps(__import__("torch"), k)
        else:
            out[k]["forced"] = [r["forced"] for r in m]
        ok = ok and out[k]["ok"]
    return out, ok


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
    summary["moe_train"], moe_ok = compare_moe_train(ranks, one)
    ok = ok and moe_ok
    serve = [(k, k) for k in SERVE_RUNS] + [
        (k, base) for k, base in FORCED_RUNS.items() if base in SERVE_RUNS]
    for name, base in serve:
        key = one_card_key(SERVE_RUNS[base])
        if key not in one["runs"] or any(name not in r["runs"]
                                         for r in ranks):
            summary[name] = {"absent": True, "ok": False}
        else:
            summary[name] = compare_serve([r["runs"][name] for r in ranks],
                                          one["runs"][key])
            if name != base:
                summary[name]["forced"] = [r["runs"][name]["forced"]
                                           for r in ranks]
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
    ap.add_argument("--parts", type=lambda t: set(t.split(",")),
                    default=set(), help="mesh and one_card: the comma-"
                    "separated parts to run (default every part)")
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
