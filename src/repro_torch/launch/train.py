"""Training launcher (counterpart of ``repro/launch/train.py``).

``--local`` (the default) runs the reduced (smoke) config in f32 with the
reference's local plan (data parallel, no remat) on the 1x1 stand-in
mesh; ``--no-local`` runs the full config under its plan for
``--shape``, with ``--seq``/``--batch`` cutting the shape's sizes to fit
one card.  The step is ``launch/steps.py``'s ``build_train_step``: real
optimizer, random batch from a seed.  Runs on the card unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --no-local --seq 4096 --batch 2
"""
from __future__ import annotations

import argparse
import math
import time
from typing import List, Optional

import torch

from repro_torch.configs.base import (ModelConfig, ShapeConfig, arch_key,
                                      get_config, get_smoke_config,
                                      shape_by_name)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.plans import Plan, get_plan
from repro_torch.launch.steps import build_train_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def make_batch(cfg: ModelConfig, B: int, S: int, device,
               generator: torch.Generator):
    """The reference launcher's batch: random tokens and advantages, a
    full loss mask, behaviour logprobs of -2, and stub inputs (patch rows,
    audio frames) drawn from N(0, 1).  The reference's stub inputs are
    zeros: a zero row's RMSNorm has the Jacobian 1/sqrt(eps) (1000 at
    1e-6), so the gradient at a vlm's patch rows grows about 1000x a
    layer and overflows to NaN at full depth (32 layers), in both
    packages; random rows train."""
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                generator=generator).to(torch.int32),
        "loss_mask": torch.ones((B, S)),
        "advantages": torch.randn((B, S), generator=generator),
        "old_logprobs": -2.0 * torch.ones((B, S)),
    }
    stub = {"vlm": "patch_embeds", "audio": "frames"}.get(cfg.family)
    if stub is not None:
        batch[stub] = torch.randn((B, cfg.num_stub_positions, cfg.d_model),
                                  generator=generator).to(cfg.compute_dtype)
    return {k: v.to(device) for k, v in batch.items()}


def main(argv: Optional[List[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--local", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config, f32, local plan (--no-local: the "
                         "full config under its plan)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (local default 64; full: the "
                         "shape's unless given)")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch (local default 4; full: the shape's unless "
                         "given)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.local:
        cfg = get_smoke_config(args.arch).replace(
            param_dtype=torch.float32, compute_dtype=torch.float32)
        plan = Plan(strategy="dp", fsdp=False, seq_parallel=False,
                    remat=False)
        shape = ShapeConfig("local", args.seq or 64, args.batch or 4,
                            "train")
    else:
        cfg = get_config(args.arch)
        plan = get_plan(arch_key(args.arch), args.shape)
        if plan is None:
            raise SystemExit(f"{args.arch} x {args.shape}: no plan (skipped)")
        full = shape_by_name(args.shape)
        if full.kind != "train":
            raise SystemExit(f"--shape {args.shape} is a {full.kind} shape")
        shape = ShapeConfig(full.name, args.seq or full.seq_len,
                            args.batch or full.global_batch, "train")

    built = build_train_step(cfg, shape, plan, make_local_mesh(), False,
                             device=args.device)
    dev = built.model.device
    gen = torch.Generator().manual_seed(0)
    params = built.model.init_params(
        torch.Generator(device=dev).manual_seed(0))
    opt = init_opt_state(params, AdamWConfig(state_dtype=plan.opt_dtype))
    batch = make_batch(cfg, shape.global_batch, shape.seq_len, dev, gen)
    losses = []
    for i in range(args.steps):
        t0 = time.monotonic()
        params, opt, metrics = built.fn(params, opt, batch)
        loss = float(metrics["loss"])
        print(f"step {i}: loss={loss:.4f} "
              f"grad_norm={float(metrics['grad_norm']):.3f} "
              f"({time.monotonic() - t0:.2f}s)")
        if not math.isfinite(loss):
            raise SystemExit(f"step {i}: loss {loss} not finite")
        losses.append(loss)
    print("OK")
    return losses


if __name__ == "__main__":
    main()
