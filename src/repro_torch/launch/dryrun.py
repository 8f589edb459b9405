"""One-card fit report (counterpart of ``repro/launch/dryrun.py``): for
each (architecture x shape) with a plan, the step's parameter counts,
model FLOPs, counted FLOPs, persistent bytes and roofline terms on one
NVIDIA H100, from a run of the step on meta tensors (no allocation).

The reference lowers and compiles each step for a TPU pod and reads
XLA's memory and cost analyses (``hlo_cost.analyse_hlo`` parses the
compiled HLO text; PyTorch has no counterpart).  Here
``torch.utils.flop_counter.FlopCounterMode`` counts the operations of
one step run on the meta device, where the kernels' wrappers take their
plain versions: attention is counted as the plain version computes it,
as XLA counted the reference's jnp attention.  Memory is the persistent
bytes only (parameters, gradients and AdamW moments for a train shape,
the cache for prefill and decode, and the batch); activations are
measured on the card, not counted here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out FILE]
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import sys
import time
from typing import Dict, Optional

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeConfig, arch_key, get_config,
                                      shape_by_name)
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     make_local_mesh)
from repro_torch.launch.plans import SKIPS, Plan, get_plan
from repro_torch.launch.steps import build_step
from repro_torch.train.optimizer import tree_leaves

# combinations the fit report does not count, beside the plans' SKIPS:
# xLSTM's sLSTM is a loop of one step per position, so a 32,768-wide
# prefill runs 196,608 block steps on meta tensors (over 15 minutes on
# one CPU core; its train_4k took 660 s); its decode shapes take 0.2 s
COUNT_SKIPS = {
    ("xlstm_125m", "prefill_32k"): "sLSTM loop over 32,768 positions: over "
                                   "15 minutes to count on meta tensors",
}
FIT_NOTE = ("persistent bytes only: parameters, gradients and AdamW "
            "moments (train), the cache (prefill, decode) and the batch; "
            "activations are measured on the card, not counted")


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def param_counts(cfg: ModelConfig, params) -> tuple:
    """(N, N_active) from the parameter tree, as the reference's dryrun
    counts them: MoE expert leaves count k / E of their size."""
    N = N_active = 0

    def walk(t, name):
        nonlocal N, N_active
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
            return
        size = math.prod(t.shape)
        N += size
        if cfg.family == "moe" and name in ("w_in", "w_gate", "w_out") \
                and t.dim() >= 3:
            size = size * cfg.moe.experts_per_token / cfg.moe.num_experts
        N_active += size
    walk(params, "")
    return N, N_active


def step_sizes(cfg: ModelConfig, shape: ShapeConfig, built) -> Dict:
    """Counts and bytes of one step, from the meta stand-ins of a built
    step (``build_step`` on any device): parameter counts, model FLOPs
    (6 N T for training, 2 N T otherwise, T the batch's tokens, one per
    row for decode) and persistent bytes (every step input, plus the
    gradients in the parameters' dtype for a train shape)."""
    params = built.in_specs[0]
    N, N_active = param_counts(cfg, params)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    persistent = tree_bytes(params) + tree_bytes(list(built.in_specs[1:]))
    if shape.kind == "train":
        persistent += tree_bytes(params)
    return {"params_total": N, "params_active": N_active,
            "model_flops": (6 if shape.kind == "train" else 2)
            * N_active * tokens,
            "persistent_bytes": persistent}


def fit_report(cfg: ModelConfig, shape: ShapeConfig, plan: Plan) -> Dict:
    """The record of one (config, shape, plan): counts, FLOPs, persistent
    bytes and roofline terms of one step on one card."""
    built = build_step(cfg, shape, plan, make_local_mesh(), False,
                       device="meta")
    sizes = step_sizes(cfg, shape, built)
    t0 = time.time()
    counter = FlopCounterMode(display=False)
    with counter:
        built.fn(*built.in_specs)
    flops = counter.get_total_flops()
    count_s = time.time() - t0

    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = sizes["persistent_bytes"] / HBM_BW
    return {
        "plan": {"strategy": plan.strategy, "fsdp": plan.fsdp,
                 "seq_parallel": plan.seq_parallel, "remat": plan.remat,
                 "microbatches": plan.microbatches,
                 "opt_dtype": str(plan.opt_dtype).replace("torch.", ""),
                 "decode_cache": plan.decode_cache},
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "num_layers": cfg.num_layers,
        "count_s": round(count_s, 1),
        **sizes,
        "flops": flops,
        "roofline": {
            "compute_s": t_compute, "memory_s": t_memory,
            "dominant": "compute" if t_compute >= t_memory else "memory",
            "useful_flops_ratio": (sizes["model_flops"] / flops if flops
                                   else 0.0),
        },
        "fits_80gb": sizes["persistent_bytes"] <= HBM_BYTES,
        "fit_note": FIT_NOTE,
    }


def analyse(arch: str, shape_name: str, verbose: bool = True,
            overrides: Optional[Dict] = None) -> Dict:
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    plan = get_plan(arch_key(arch), shape_name)
    skip = SKIPS.get((arch_key(arch), shape_name)) or COUNT_SKIPS.get(
        (arch_key(arch), shape_name))
    if skip is not None:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": skip}
    if overrides:
        plan = dataclasses.replace(plan, **overrides)
    rec = {"arch": arch, "shape": shape_name, "mesh": "1xH100",
           **fit_report(cfg, shape, plan)}
    if verbose:
        r = rec["roofline"]
        print(f"== {arch} x {shape_name} (1xH100) counted in "
              f"{rec['count_s']}s")
        print(f"   params={rec['params_total']:.4e} "
              f"active={rec['params_active']:.4e} "
              f"persistent={rec['persistent_bytes'] / 1e9:.2f}GB "
              f"fits_80gb={rec['fits_80gb']}")
        print(f"   flops={rec['flops']:.3e} model_flops="
              f"{rec['model_flops']:.3e} compute={r['compute_s'] * 1e3:.2f}ms "
              f"memory={r['memory_s'] * 1e3:.2f}ms dominant={r['dominant']} "
              f"useful={r['useful_flops_ratio']:.2f}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", default=None,
                    help="plan overrides, e.g. 'microbatches=1,remat=False'")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) \
        else [args.shape]
    overrides = {}
    if args.override:
        for kv in args.override.split(","):
            k, v = kv.split("=")
            overrides[k] = ast.literal_eval(v)
    results, failures = [], 0
    for a in archs:
        for s in shapes:
            try:
                rec = analyse(a, s, overrides=overrides or None)
                if rec.get("skipped"):
                    print(f"== {a} x {s}: SKIPPED ({rec['reason']})")
            except Exception as e:  # noqa: BLE001 - one report per combo
                failures += 1
                print(f"== {a} x {s} FAILED: {type(e).__name__}: {e}")
                rec = {"arch": a, "shape": s,
                       "error": f"{type(e).__name__}: {e}"}
            results.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
