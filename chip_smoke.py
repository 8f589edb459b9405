#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                   # every phase but variants
    python3 chip_smoke.py --phase kernels   # build + kernel checks only
    python3 chip_smoke.py --phase variants  # + design variants, ablations
    python3 chip_smoke.py --phase rl        # kernel checks + the rl phase
    python3 chip_smoke.py --phase group     # kernel checks + the control
                                            # plane (group, serve_tier,
                                            # long, the option sessions)

Phases, each printing one JSON line:

1. ``kernels``: build the five CUDA kernels from ``src/repro_torch/
   kernels/csrc`` and hold each against its plain PyTorch version on the
   card, at the serve phase's shapes and at edge shapes, with the
   tolerance stated beside each case (the decode kernels also at the
   edges of their row splits); check that no decode instantiation
   spills registers; time the wrapper (``ms``), the device time of the
   launches one call makes (``kernel_ms``, torch.profiler), the plain
   version and a PyTorch yardstick (``library_ms``, never called by the
   port).
2. ``serve``: Qwen3-0.6B at full width and depth (28 layers, bf16, random
   weights from a seed) behind the ``SlotEngine``, continuous batching as
   in ``examples/serve_batch.py``, one path after another, each with the
   launch counts zeroed just before it and checked just after against
   the kernels that path must launch (and no other):
   ``main`` (paged fp pool, fused greedy head; 96 requests as 24 GRPO
   groups of 4 sharing a prompt of 64-1024 tokens), ``dense``
   (``paged=False``; 32 requests, 8 groups), ``int8`` (``kv_quant=
   "int8"``, fused head; 48 requests, 12 groups, through 32 slots),
   ``packed`` (one packed-prefill wave) and ``sampled`` (8 steps at
   temperature 1).
3. ``e2e``: greedy engine tokens and logprobs against the port's plain
   full-sequence ``forward`` (plain attention, no kernels): 4 layers in
   f32 on the paged, dense and int8 engines, and 4 requests each of the
   main and dense paths in bf16.
4. ``group``: two 16-slot replicas of the paged engine behind the port's
   ``EngineGroup`` (``least_tokens``, ``migrate_kv=True``, greedy fused
   decode, the serve phase's weights with EOS's row calibrated so that
   greedy streams end at about 2% of their steps), driven by the
   ``RolloutOrchestrator`` (``sorted``, partial mode, update batches of
   16) over the rl phase's 16 GRPO groups of 4, while a ``FaultInjector``
   kills replica 1 a third of the way in: every uid trained once, one
   death and at least one KV migration (export -> import -> discard,
   timed), exactly the flash, paged decode and fused-head launches, and
   greedy streams equal to one 32-slot engine's on the same prompts but
   where the plain forward sees a near-tie (0.1 nats).  ``serve_tier``:
   the ``ServingOrchestrator`` with two tenants' Poisson arrivals (64,
   prompts of 64-512 ids, a fixed tick) into an elastic fleet that
   starts at one replica under the ``queue_depth`` autoscaler:
   per-tenant conservation, at least one scale event (each printed with
   the card's allocated memory after it), the same three kernels.
5. ``rl``: SortedRL's loop at full width and depth on the serve phase's
   bf16 weights: the paged ``SlotEngine`` rolls out 16 GRPO groups of 4
   (prompts of 64-192 ids) at temperature 1 through the
   ``RolloutOrchestrator`` (``sorted`` policy, partial mode, 32 slots,
   update batches of 16), and ``RLTrainer`` (PPO-clip, GRPO, AdamW at lr
   1e-5) updates the weights the engine reads, at least 3 times.  The
   first batch's behaviour logprobs are held against the trainer's plain
   forward (max 0.1, mean 0.01 nats); the rollout must launch the flash
   and paged decode kernels and the train steps none.  Then
   ``RLSession.from_config(SessionConfig(task="logic", n_groups=2,
   sft_steps=20)).run()``, the tiny f32 session, on the card to its
   ``final_eval`` (line ``rl_session``), and four more tiny sessions
   with the control plane's options: ``num_replicas=2`` with a
   ``fault_plan`` kill, ``autoscaler="bubble_target"``, ``arrival``
   (two tenants) and ``engine="sim"``, each to its end with a finite
   history and its launches checked (line ``rl_session_options``).
6. ``long``: the trainer's loss (PPO-clip over ``token_logprobs`` of the
   plain ``forward``) forward and backward at B=1, S=2304 on the full
   model: above ``FULL_ATTN_MAX_SEQ``, so every layer attends blockwise
   (counted); its time (twice), one traced run and peak memory.

``--phase variants`` adds, after the kernel checks, one more line: the
bf16 flash, fused-head and paged decode (fp and int8 pages) kernels
rebuilt from text edits of their committed sources (another design
choice, or one part removed) and timed through their C entry points at
the serve shapes, to show where their time goes.

Then the ``kernels`` summary line, the card's name and power limit from
``nvidia-smi``, and last ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero.  Needs one CUDA card; details go to ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
PEAK_BYTES_S = 3.35e12                     # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, non-TF32 f32
FAILURES = []
LINES = OUT / "chip_smoke_all.jsonl"       # every emitted line of this run


def emit(obj) -> None:
    """Print one JSON line, and keep it in the output directory ``OUT``
    (a long run's output may be read only from its end)."""
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LINES, "a") as f:
        f.write(line + "\n")


def check(cond: bool, what: str) -> None:
    if not cond:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)


def cuda_ms(torch, fn, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, between CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def device_ms(torch, fn, n: int = 20):
    """Device time of the kernels one call of ``fn`` launches, summed
    (torch.profiler's CUDA kernel durations over ``n`` calls, divided by
    n), and per kernel its launches and device ms per call: the kernel
    without the host time of its wrapper, which ``cuda_ms`` times back to
    back."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # a profile now and then comes back without its device events (one
    # of 32 in one run, a kernel that the next profile saw); up to three
    # profiles, and no device time in all three fails the run
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages()
                if r.device_type == torch.autograd.DeviceType.CUDA]
        ms = sum(r.self_device_time_total for r in rows) / 1e3 / n
        if ms > 0:
            break
    check(ms > 0, f"profiler saw no device time for {fn}")
    return ms, {r.key[:60]: {"launches": r.count / n,
                             "ms": r.self_device_time_total / 1e3 / n}
                for r in rows}


def timings(torch, fn, plain, library, ms_reps=(7, 10), plain_reps=(5, 3)):
    """ms (wrapper, CUDA events), kernel_ms (device time of the call's
    launches), plain_ms and library_ms, measured in this run."""
    ms = cuda_ms(torch, fn, *ms_reps)          # before the profiler runs
    kernel_ms, per_call = device_ms(torch, fn)
    return dict(ms=ms, kernel_ms=kernel_ms,
                kernels_per_call=per_call,
                plain_ms=cuda_ms(torch, plain, *plain_reps),
                library_ms=cuda_ms(torch, library, reps=5, inner=3))


# ---------------------------------------------------------------------------
# Phase 1: kernels
# ---------------------------------------------------------------------------

def paged_inputs(torch, dev, dtype, kv_lens, H, Kh, D, P=16, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    B = len(kv_lens)
    need = [max(1, -(-int(n) // P)) for n in kv_lens]
    nb = 1 << (max(need) - 1).bit_length()
    N = sum(need) + 1
    perm = rng.permutation(np.arange(1, N))
    bt = np.zeros((B, nb), np.int32)          # unused entries: page 0
    o = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[o:o + n]
        o += n
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn((N, P, Kh, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((N, P, Kh, D), generator=g, device=dev).to(dtype)
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.tensor(list(kv_lens), dtype=torch.int32, device=dev))


def dense_inputs(torch, dev, dtype, kv_lens, S, H, Kh, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(kv_lens)
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, Kh, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, Kh, D), generator=g, device=dev).to(dtype)
    return q, k, v, torch.tensor(list(kv_lens), dtype=torch.int32,
                                 device=dev)


def int8_inputs(ref, args):
    """int8 pages (``quantize_pages_ref``) of fp ``paged_inputs``."""
    q, kp, vp, bt, kvl = args
    (k8, ks), (v8, vs) = ref.quantize_pages_ref(kp), ref.quantize_pages_ref(vp)
    return q, k8, v8, ks, vs, bt, kvl


def bound(nbytes, flops, kind="bfloat16"):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[kind]
    return {"bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def flash_inputs(torch, dev, dtype, B, S, H, Kh, D, seg=False, seed=0):
    import numpy as np
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, Kh, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, Kh, D), generator=g, device=dev).to(dtype)
    seg_ids = None
    if seg:
        # engine-style packing: page-aligned segments, -1 padded tail
        rng = np.random.RandomState(seed)
        s = np.full((B, S), -1, np.int32)
        for b in range(B):
            off, i = 0, 0
            while off < S:
                span = int(rng.randint(1, 9)) * 16
                if off + span > S - (S // 8):
                    break
                s[b, off:off + span] = i
                off += span
                i += 1
        seg_ids = torch.from_numpy(s).to(dev)
    return q, k, v, seg_ids


def visible_pairs(S, window, seg):
    """(query, key) pairs the causal/window/segment masks let through,
    summed over the batch (the work the kernel's inputs need)."""
    import numpy as np
    qpos = np.arange(S)[:, None]
    kpos = np.arange(S)[None, :]
    m = kpos <= qpos
    if window:
        m &= (qpos - kpos) < window
    if seg is None:
        return int(m.sum())
    total = 0
    for row in seg:
        total += int((m & (row[:, None] == row[None, :])).sum())
    return total


# kernel -> (library, regex of its bf16 instantiation's function names)
BF16_FUNCTIONS = {
    "flash_attention": ("flash_attention", r"flash_tc_kernel"),
    "fused_sample": ("fused_sample", r"sample_tc_kernel"),
    "paged_decode_attention": ("paged_decode_attention",
                               r"decode_split_kernelI13__nv_bfloat16S"),
    "paged_decode_attention_int8": ("paged_decode_attention",
                                    r"decode_split_kernelI13__nv_bfloat16a"),
    "ragged_decode_attention": ("ragged_decode_attention",
                                r"decode_split_kernelI13__nv_bfloat16"),
}
TENSOR_CORE_OPS = re.compile(r"\bHG?MMA\.")   # mma.sync -> HMMA, wgmma -> HGMMA
# decode kernel -> (library, regex of every instantiation: f32 and bf16,
# D 64/128, G 1/2/4/8, f32 D 32 G 1 on fp pages, and the merge pass)
DECODE_FUNCTIONS = {
    "paged_decode_attention": ("paged_decode_attention",
                               r"decode_split_kernelI(ff|13__nv_bfloat16S)"
                               r"|decode_merge_kernel"),
    "paged_decode_attention_int8": ("paged_decode_attention",
                                    r"decode_split_kernelI(f|13__nv_bfloat16)a"
                                    r"|decode_merge_kernel"),
    "ragged_decode_attention": ("ragged_decode_attention",
                                r"decode_(split|merge)_kernel"),
}


def ptxas_functions(log: str, pattern: str):
    """function -> registers and spill bytes (stores + loads), from an
    ``-Xptxas -v`` log, for the entry functions matching ``pattern``."""
    out = {}
    for blk in log.split("Compiling entry function '")[1:]:
        fn = blk.split("'", 1)[0]
        if re.search(pattern, fn):
            r = re.search(r"Used (\d+) registers", blk)
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", blk)
            out[fn] = {"registers": int(r.group(1)) if r else None,
                       "spill_bytes": (int(sp.group(1)) + int(sp.group(2))
                                       if sp else None)}
    return out


# split-pass instantiations per decode kernel: 2 dtypes x D 64/128 x G
# 1/2/4/8, and for fp pages also f32 at D 32, G 1 (the RL session's LM)
DECODE_SPLIT_INSTANTIATIONS = {"paged_decode_attention": 17,
                               "paged_decode_attention_int8": 16,
                               "ragged_decode_attention": 16}


def decode_registers(build):
    """Registers and spills of every decode instantiation; checked: the
    split-pass instantiations of ``DECODE_SPLIT_INSTANTIATIONS``, none
    spills."""
    out = {}
    for name, (lib, pat) in DECODE_FUNCTIONS.items():
        fns = ptxas_functions(build.ptxas_report(lib), pat)
        n_split = sum("decode_split_kernel" in fn for fn in fns)
        spill = sum(v["spill_bytes"] or 0 for v in fns.values())
        check(n_split == DECODE_SPLIT_INSTANTIATIONS[name]
              and all(v["spill_bytes"] is not None for v in fns.values()),
              f"{name}: {n_split} split instantiations in the ptxas log")
        check(spill == 0, f"{name}: register spills {fns}")
        out[name] = {"functions": len(fns),
                     "max_registers": max((v["registers"] or 0
                                           for v in fns.values()), default=None),
                     "spill_bytes": spill, "per_function": fns}
    return out


def sass_and_registers(build):
    """Per kernel, its bf16 instantiation's functions: tensor-core
    instructions in the SASS (``cuobjdump -sass`` on the built library)
    and registers / spill bytes (nvcc's ``-Xptxas -v`` log)."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass, out = {}, {}
    for lib in sorted({lib for lib, _ in BF16_FUNCTIONS.values()}):
        txt = subprocess.run([str(tool), "-sass", str(build.lib_path(lib))],
                             capture_output=True, text=True,
                             timeout=120).stdout
        sass[lib] = {blk.split(None, 1)[0]: len(TENSOR_CORE_OPS.findall(blk))
                     for blk in txt.split("Function : ")[1:] if blk.strip()}
    for name, (lib, pat) in BF16_FUNCTIONS.items():
        regs = ptxas_functions(build.ptxas_report(lib), pat)
        fns = {fn: n for fn, n in sass[lib].items() if re.search(pat, fn)}
        out[name] = {"functions": len(fns),
                     "tensor_core_ops": sum(fns.values()),
                     "min_per_function": min(fns.values()) if fns else 0,
                     "max_registers": max((v["registers"] or 0
                                           for v in regs.values()), default=None),
                     "spill_bytes": sum(v["spill_bytes"] or 0
                                        for v in regs.values())}
    (OUT / "sass_tensor_ops.json").write_text(json.dumps(sass, indent=1))
    return out


def phase_kernels(torch, dev, report):
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref

    t0 = time.monotonic()
    libs = build.build_all()
    build_s = time.monotonic() - t0
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.txt").write_text("\n".join(
        f"== {n}\n{build.ptxas_report(n)}" for n in libs))
    sass = sass_and_registers(build)
    for name in ("flash_attention", "fused_sample"):
        got = sass[name]
        check(got["functions"] > 0 and got["min_per_function"] > 0,
              f"{name}: bf16 SASS has no tensor-core instruction {got}")
        check(got["spill_bytes"] == 0, f"{name}: bf16 register spills {got}")
    for name in sass:
        report.setdefault(name, {})["sass_bf16"] = sass[name]
    regs = decode_registers(build)
    (OUT / "decode_registers.json").write_text(json.dumps(regs, indent=1))
    for name, r in regs.items():
        report[name]["registers"] = {k: v for k, v in r.items()
                                     if k != "per_function"}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []

    def record(kernel, case, err, tol, extra=None, excess=None, rtol=0.0):
        """``err`` is the max abs error; the case passes if ``err <= tol``,
        or with ``rtol`` if ``excess`` (max of |out - want| - rtol*|want|)
        is at most ``tol``."""
        ok = bool((err if excess is None else excess) <= tol)
        check(ok, f"{kernel}/{case}: max_abs_err {err:.3g} > tol {tol}"
              + (f" + {rtol:.3g}*|want|" if rtol else ""))
        row = {"kernel": kernel, "case": case, "max_abs_err": err,
               "tol": tol, "rtol": rtol, "excess": excess, "ok": ok}
        row.update(extra or {})
        cases.append(row)
        return row

    def maxerr(a, b):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0

    def max_excess(out, want, rtol):
        o, w = out.float(), want.float()
        return float(((o - w).abs() - rtol * w.abs()).max()) \
            if o.numel() else 0.0

    # -- paged_decode_attention ----------------------------------------------
    # tolerance: f32 1e-4 (only the order of f32 sums differs); bf16 2e-2:
    # the plain version (like the reference's jnp decode_attention) rounds
    # q/sqrt(D) and the softmax weights to bf16 before its products, the
    # kernel (like the Pallas body) keeps them in f32; outputs are O(1).
    import numpy as np
    from repro_torch.kernels import paged_decode_attention as pdm
    serve_lens = np.asarray(serve_decode_lens())
    # edges of the split-KV decode (shared by the three decode kernels):
    # kv_len around and at whole splits of SR rows, one slot over every
    # split of a 2048-row table, 33 slots, G = 8 with softcap across splits
    SR = pdm.split_rows()
    edges = [SR - 1, SR, SR + 1, 2 * SR]
    b33 = np.random.RandomState(12).randint(1, 1500, size=33).tolist()
    g8 = [600, 2 * SR + 7, 5]
    pd_cases = [
        ("serve_b32_bf16", bf16, serve_lens.tolist(), 16, 8, 128, 0.0),
        ("serve_b32_f32", f32, serve_lens.tolist(), 16, 8, 128, 0.0),
        ("kvlen_0_1_37_bf16", bf16, [0, 1, 37], 16, 8, 128, 0.0),
        ("kvlen_0_1_37_f32", f32, [0, 1, 37], 16, 8, 128, 0.0),
        ("d64_g4_softcap_f32", f32, [5, 16, 33, 300], 8, 2, 64, 30.0),
        ("d64_g1_bf16", bf16, [17, 129, 1], 4, 4, 64, 0.0),
        ("d128_g8_softcap_bf16", bf16, [100, 256, 31], 8, 1, 128, 30.0),
        ("split_edges_bf16", bf16, edges, 16, 8, 128, 0.0),
        ("split_edges_f32", f32, edges, 16, 8, 128, 0.0),
        ("b1_2048_rows_bf16", bf16, [2048], 16, 8, 128, 0.0),
        ("b1_2048_rows_f32", f32, [2048], 16, 8, 128, 0.0),
        ("b33_kh8_bf16", bf16, b33, 16, 8, 128, 0.0),
        ("g8_softcap_splits_bf16", bf16, g8, 8, 1, 128, 30.0),
        ("d64_g8_softcap_splits_f32", f32, [600, SR + 1, 5], 8, 1, 64, 30.0),
        ("d64_g2_split_edges_bf16", bf16, edges, 8, 4, 64, 0.0),
        # the RL session's tiny LM (f32, D = 32, G = 1), across a split
        ("tiny_d32_g1_f32", f32, [1, 37, 159, SR + 3], 4, 4, 32, 0.0),
    ]
    serve_pd = None
    for name, dt, lens, H, Kh, D, cap in pd_cases:
        args = paged_inputs(torch, dev, dt, lens, H, Kh, D)
        out = ops.paged_decode_attention(*args, softcap=cap)
        want = ref.paged_decode_attention_ref(*args, softcap=cap)
        torch.cuda.synchronize()
        tol = 1e-4 if dt == f32 else 2e-2
        row = record("paged_decode_attention", name, maxerr(out, want), tol)
        if 0 in lens:
            zero = out[[i for i, n in enumerate(lens) if n == 0]]
            check(bool((zero == 0).all()), f"paged/{name}: kv_len 0 not zero")
        if name == "serve_b32_bf16":
            serve_pd = (args, row)
    args, row = serve_pd
    q, kp, vp, bt, kvl = args
    es = q.element_size()
    live = int(kvl.sum())
    B, H, D = q.shape
    Kh = kp.shape[2]
    nbytes = 2 * q.numel() * es + 2 * live * Kh * D * es \
        + bt.numel() * 4 + kvl.numel() * 4
    flops = 4 * live * H * D
    kg = ref.gather_pages(kp, bt).transpose(1, 2)      # (B, Kh, S, D)
    mask = (torch.arange(kg.shape[2], device=dev)[None, :]
            < kvl[:, None])[:, None, None, :]
    G = H // Kh

    def library():
        k_ = ref.gather_pages(kp, bt).transpose(1, 2).repeat_interleave(G, 1)
        v_ = ref.gather_pages(vp, bt).transpose(1, 2).repeat_interleave(G, 1)
        return F.scaled_dot_product_attention(q[:, :, None], k_, v_,
                                              attn_mask=mask)
    del kg
    report["paged_decode_attention"].update(
        max_abs_err=row["max_abs_err"], tol=row["tol"],
        **timings(torch, lambda: ops.paged_decode_attention(*args),
                  lambda: ref.paged_decode_attention_ref(*args), library),
        **bound(nbytes, flops),
        shape=dict(B=B, H=H, Kh=Kh, D=D, P=16, live_rows=live))

    # -- ragged_decode_attention (dense cache) -------------------------------
    # tolerance: as for the paged kernel, whose body it shares: f32 1e-4,
    # bf16 2e-2 (the plain version rounds q/sqrt(D) and the weights to
    # bf16 as the reference's jnp decode does, the kernel keeps f32).
    # The serve shape is the dense engine's cache (S = max_total_len
    # 2048) at the paged serve lengths; S = 64 and 300 are not multiples
    # of 128, kv_len > S reads all S rows.
    rd_cases = [
        ("serve_b32_s2048_bf16", bf16, serve_lens.tolist(), 2048, 16, 8, 128,
         0.0),
        ("serve_b32_s2048_f32", f32, serve_lens.tolist(), 2048, 16, 8, 128,
         0.0),
        ("kvlen_0_1_37_s64_bf16", bf16, [0, 1, 37], 64, 16, 8, 128, 0.0),
        ("kvlen_0_1_37_s64_f32", f32, [0, 1, 37], 64, 16, 8, 128, 0.0),
        ("s300_kvlen_over_s_f32", f32, [400, 299, 5, 300], 300, 16, 8, 128,
         0.0),
        ("d64_g4_softcap_s64_f32", f32, [5, 16, 33, 64], 64, 8, 2, 64, 30.0),
        ("d64_g1_s300_bf16", bf16, [17, 129, 1], 300, 4, 4, 64, 0.0),
        ("d128_g8_softcap_bf16", bf16, [100, 256, 31], 300, 8, 1, 128, 30.0),
        ("split_edges_bf16", bf16, edges, 2 * SR, 16, 8, 128, 0.0),
        ("split_edges_f32", f32, edges, 2 * SR, 16, 8, 128, 0.0),
        ("b1_s2048_bf16", bf16, [2048], 2048, 16, 8, 128, 0.0),
        ("b33_kh8_s1500_bf16", bf16, b33, 1500, 16, 8, 128, 0.0),
        ("g8_softcap_splits_s700_bf16", bf16, g8, 700, 8, 1, 128, 30.0),
    ]
    serve_rd = None
    for name, dt, lens, S, H, Kh, D, cap in rd_cases:
        args = dense_inputs(torch, dev, dt, lens, S, H, Kh, D)
        out = ops.ragged_decode_attention(*args, softcap=cap)
        want = ref.ragged_decode_attention_ref(*args, softcap=cap)
        torch.cuda.synchronize()
        row = record("ragged_decode_attention", name, maxerr(out, want),
                     1e-4 if dt == f32 else 2e-2)
        if 0 in lens:
            zero = out[[i for i, n in enumerate(lens) if n == 0]]
            check(bool((zero == 0).all()), f"ragged/{name}: kv_len 0 not zero")
        if name == "serve_b32_s2048_bf16":
            serve_rd = (args, row)
        del args, out, want
    args, row = serve_rd
    q, kc, vc, kvl = args
    B, H, D = q.shape
    S, Kh = kc.shape[1], kc.shape[2]
    G = H // Kh
    es = q.element_size()
    live = int(kvl.clamp(max=S).sum())
    nbytes = 2 * q.numel() * es + 2 * live * Kh * D * es + kvl.numel() * 4
    # yardstick: SDPA with a key mask over the dense cache, in the
    # head-major GQA-expanded layout it needs, prepared outside the timer
    kt = kc.transpose(1, 2).repeat_interleave(G, 1)
    vt = vc.transpose(1, 2).repeat_interleave(G, 1)
    mask = (torch.arange(S, device=dev)[None, :]
            < kvl[:, None])[:, None, None, :]
    report["ragged_decode_attention"].update(
        max_abs_err=row["max_abs_err"], tol=row["tol"],
        **timings(torch, lambda: ops.ragged_decode_attention(*args),
                  lambda: ref.ragged_decode_attention_ref(*args),
                  lambda: F.scaled_dot_product_attention(
                      q[:, :, None], kt, vt, attn_mask=mask)),
        **bound(nbytes, 4 * live * H * D),
        shape=dict(B=B, H=H, Kh=Kh, D=D, S=S, live_rows=live,
                   library="SDPA, key mask, cache pre-transposed"))
    del args, q, kc, vc, kt, vt, mask

    # -- paged_decode_attention over int8 pages -------------------------------
    # Inputs: int8 pages and per-page f32 scales from quantize_pages_ref of
    # random fp pages, and each slot's new row (k/v_new, q's dtype), which
    # both sides read unquantised in place of row kv_len - 1, as the
    # reference engine attends before it requantises.  The plain version
    # dequantises the gathered pages to f32 and runs the plain decode in
    # f32; the kernel dequantises the same values (float(q) * scale) in
    # registers and computes in f32.  f32 q: only
    # the order of the f32 sums differs, 1e-4.  bf16 q: 2e-2, the paged
    # kernel's bf16 bound, for the same reason: the plain decode, as the
    # reference's oracle, rounds q/sqrt(D) to q's dtype before its f32
    # products, the kernel keeps it in f32 as the Pallas body does; a
    # relative 2^-9 on every score moves O(1) outputs by a few bf16 steps
    # (0.0039 and 0.0078 seen on the card against a 1e-3 + 2^-7*|want|
    # bound that allowed one step).
    i8_cases = [
        ("serve_b32_bf16", bf16, serve_lens.tolist(), 16, 8, 128, 0.0, None),
        ("serve_b32_f32", f32, serve_lens.tolist(), 16, 8, 128, 0.0, None),
        ("kvlen_0_1_37_bf16", bf16, [0, 1, 37], 16, 8, 128, 0.0, None),
        ("d64_g4_softcap_f32", f32, [5, 16, 33, 300], 8, 2, 64, 30.0, None),
        ("d64_g1_bf16", bf16, [17, 129, 1], 4, 4, 64, 0.0, None),
        ("zero_page_f32", f32, [40, 20, 33], 16, 8, 128, 0.0, "zero"),
        ("cow_shared_scale_bf16", bf16, [40, 37, 20], 16, 8, 128, 0.0, "cow"),
        # new rows with one element at 1.5x what their page's scale holds:
        # quantised into the page they would raise its scale; here they
        # are read unquantised, as the reference reads them
        ("new_row_raises_scale_bf16", bf16, [40, 16, 33, 1], 16, 8, 128, 0.0,
         "raise"),
        ("new_row_raises_scale_f32", f32, [40, 16, 33, 1], 16, 8, 128, 30.0,
         "raise"),
        ("split_edges_bf16", bf16, edges, 16, 8, 128, 0.0, None),
        ("b1_2048_rows_bf16", bf16, [2048], 16, 8, 128, 0.0, None),
        ("b33_kh8_bf16", bf16, b33, 16, 8, 128, 0.0, None),
        # the new row (kv_len - 1) the first row of a split (the split then
        # reads no pool row), and the last row of a split
        ("new_row_first_of_split_f32", f32, [SR + 1, 2 * SR + 1, 1], 16, 8,
         128, 0.0, None),
        ("new_row_first_of_split_bf16", bf16, [SR + 1, 2 * SR + 1, 1], 16, 8,
         128, 0.0, None),
        ("new_row_last_of_split_f32", f32, [SR, 2 * SR, 3 * SR], 16, 8, 128,
         0.0, None),
        ("g8_softcap_splits_bf16", bf16, g8, 8, 1, 128, 30.0, None),
        ("d64_g4_softcap_splits_f32", f32, [600, SR + 1, 5], 8, 2, 64, 30.0,
         None),
    ]
    serve_i8 = None
    for name, dt, lens, H, Kh, D, cap, special in i8_cases:
        q, kp, vp, bt, kvl = paged_inputs(torch, dev, dt, lens, H, Kh, D)
        if special == "zero":
            # slot 0's second page all zero: scale 1e-8/127, cells 0
            kp[bt[0, 1]] = 0
            vp[bt[0, 1]] = 0
        args = int8_inputs(ref, (q, kp, vp, bt, kvl))
        if special == "cow":
            # slots 0 and 1 share slot 0's first page, as a GRPO prefix
            # does, and slot 2's first page is a copy-on-write copy of it:
            # one scale read by rows of three slots, and copied with its
            # page
            _, k8, v8, ks, vs, bt, _ = args
            src, dst = int(bt[0, 0]), int(bt[2, 0])
            bt[1, 0] = src
            for pages, scales in ((k8, ks), (v8, vs)):
                pages[dst] = pages[src]
                scales[dst] = scales[src]
        gn = torch.Generator(device=dev).manual_seed(len(lens))
        new = {n: torch.randn((len(lens), Kh, D), generator=gn,
                              device=dev).to(dt) for n in ("k_new", "v_new")}
        if special == "raise":
            _, _, _, ks_, vs_, bt_, kvl_ = args
            last = (kvl_.long() - 1).clamp(min=0)
            page = bt_[torch.arange(len(lens), device=dev), last // 16].long()
            for n, sc_ in (("k_new", ks_), ("v_new", vs_)):
                new[n][:, :, 0] = (1.5 * 127 * sc_[page])[:, None].to(dt)
                check(bool((new[n].float().abs().amax((1, 2))
                            > 127 * sc_[page]).all()),
                      f"int8/{name}: {n} does not exceed its page's scale")
        out = ops.paged_decode_attention_int8(*args, softcap=cap, **new)
        want = ref.paged_decode_attention_int8_ref(*args, softcap=cap, **new)
        torch.cuda.synchronize()
        row = record("paged_decode_attention_int8", name, maxerr(out, want),
                     1e-4 if dt == f32 else 2e-2)
        if special == "zero":
            check(abs(float(args[3][bt[0, 1]]) * 127 - 1e-8) < 1e-12,
                  "int8 zero page: scale not at its 1e-8 floor")
        if 0 in lens:
            zero = out[[i for i, n in enumerate(lens) if n == 0]]
            check(bool((zero == 0).all()), f"int8/{name}: kv_len 0 not zero")
        if name == "serve_b32_bf16":
            serve_i8 = (args, new, row)
        del q, kp, vp, args, out, want
    args, new, row = serve_i8
    q, k8, v8, ks, vs, bt, kvl = args
    B, H, D = q.shape
    P, Kh = k8.shape[1], k8.shape[2]
    G = H // Kh
    live = int(kvl.sum())
    live_pages = sum(-(-int(n) // P) for n in kvl.tolist())
    # the new rows replace one pool row per slot: read in q's dtype
    nbytes = 2 * q.numel() * q.element_size() + 2 * (live - B) * Kh * D \
        + 2 * B * Kh * D * q.element_size() \
        + 2 * live_pages * 4 + bt.numel() * 4 + kvl.numel() * 4
    mask = (torch.arange(bt.shape[1] * P, device=dev)[None, :]
            < kvl[:, None])[:, None, None, :]

    def library():
        # gather + dequantise + SDPA
        def deq(pages, scales):
            g = ref.gather_pages(pages, bt).float() * scales[bt.long()] \
                .repeat_interleave(P, 1)[:, :, None, None]
            return g.to(q.dtype).transpose(1, 2).repeat_interleave(G, 1)
        return F.scaled_dot_product_attention(q[:, :, None], deq(k8, ks),
                                              deq(v8, vs), attn_mask=mask)
    report["paged_decode_attention_int8"].update(
        max_abs_err=row["max_abs_err"], tol=row["tol"],
        **timings(torch,
                  lambda: ops.paged_decode_attention_int8(*args, **new),
                  lambda: ref.paged_decode_attention_int8_ref(*args, **new),
                  library),
        **bound(nbytes, 4 * live * H * D),
        shape=dict(B=B, H=H, Kh=Kh, D=D, P=P, live_rows=live,
                   live_pages=live_pages, q="bfloat16"))
    del args, new, q, k8, v8, mask

    # -- flash_attention ------------------------------------------------------
    # tolerance: f32 (the FMA kernel) 1e-4: only the order of f32 sums
    # differs.  bf16 (the tensor-core kernel), per element:
    #   1e-3 + 2^-7*|want| + 2^-9*attn(|v|).
    # Scores and softmax are f32 on both sides from the same bf16 inputs
    # and both round the output to bf16, so two f32 results a sum order
    # apart can land one bf16 step apart (at most 2^-7 of the value); 1e-3
    # covers outputs near zero.  The kernel also rounds P to bf16 before
    # P V (the plain version keeps f32): each weight moves by at most 2^-9
    # of itself, so an output by at most 2^-9 * sum p|v| / sum p, which is
    # the plain attention of the same scores over |v| (attn(|v|), computed
    # per case; ~0.8 for random v, so this term is ~0.0016).  Late causal
    # rows average hundreds of keys (|out| ~ 0.05): a dropped or doubled
    # 64-key tile moves them by ~0.01-0.04 and earlier rows by far more,
    # beyond this bound, so it still catches both.
    fa_rtol, fa_p = 2.0 ** -7, 2.0 ** -9
    fa_cases = [
        ("serve_b8_s1024_bf16", bf16, 8, 1024, 16, 8, 128, False, 0, 0.0),
        ("serve_b8_s1024_f32", f32, 8, 1024, 16, 8, 128, False, 0, 0.0),
        ("serve_packed_b4_s2048_bf16", bf16, 4, 2048, 16, 8, 128, True, 0,
         0.0),
        ("s1_f32", f32, 2, 1, 16, 8, 128, False, 0, 0.0),
        ("s37_seg_f32", f32, 2, 37, 4, 2, 64, True, 0, 0.0),
        ("s300_window64_softcap_f32", f32, 2, 300, 4, 2, 64, False, 64, 30.0),
        ("s300_seg_window_bf16", bf16, 1, 300, 8, 2, 128, True, 100, 0.0),
        ("s37_d128_bf16", bf16, 3, 37, 16, 8, 128, False, 0, 30.0),
        # edges of the tensor-core kernel: S around its 64-row tiles, D 64
        # and 128, G = H / Kh in {1, 2, 4}, window, softcap, segments
        ("s63_d64_g1_bf16", bf16, 2, 63, 4, 4, 64, False, 0, 0.0),
        ("s64_d128_g2_softcap_bf16", bf16, 2, 64, 8, 4, 128, False, 0, 30.0),
        ("s65_d64_g4_window40_bf16", bf16, 2, 65, 8, 2, 64, False, 40, 0.0),
        ("s127_d128_g4_seg_bf16", bf16, 2, 127, 8, 2, 128, True, 0, 0.0),
        ("s128_d64_g2_seg_window_softcap_bf16", bf16, 2, 128, 8, 4, 64, True,
         50, 30.0),
        ("s129_d128_g1_window100_bf16", bf16, 2, 129, 4, 4, 128, False, 100,
         0.0),
        ("s2048_d128_g2_bf16", bf16, 1, 2048, 16, 8, 128, False, 0, 0.0),
        ("s2048_d64_g4_seg_softcap_window_bf16", bf16, 1, 2048, 8, 2, 64, True,
         700, 30.0),
        ("s129_d64_g4_window_f32", f32, 2, 129, 8, 2, 64, False, 100, 0.0),
        # the RL session's tiny LM (f32, D = 32), ragged S
        ("tiny_s97_d32_f32", f32, 8, 97, 4, 4, 32, False, 0, 0.0),
    ]
    serve_fa = None
    for name, dt, B, S, H, Kh, D, seg, win, cap in fa_cases:
        q, k, v, s = flash_inputs(torch, dev, dt, B, S, H, Kh, D, seg)
        out = ops.flash_attention(q, k, v, seg_ids=s, window=win,
                                  softcap=cap)
        want = ref.flash_attention_ref(q, k, v, window=win, softcap=cap,
                                       seg_ids=s)
        torch.cuda.synchronize()
        if dt == f32:
            row = record("flash_attention", name, maxerr(out, want), 1e-4)
        else:
            wabs = ref.flash_attention_ref(q, k, v.abs(), window=win,
                                           softcap=cap, seg_ids=s).float()
            excess = float(((out.float() - want.float()).abs()
                            - fa_rtol * want.float().abs()
                            - fa_p * wabs).max())
            row = record("flash_attention", name, maxerr(out, want), 1e-3,
                         {"p_rounding": "2^-9*attn(|v|)",
                          "max_attn_abs_v": float(wabs.max())},
                         excess=excess, rtol=fa_rtol)
            del wabs
        if name == "serve_b8_s1024_bf16":
            serve_fa = ((q, k, v), row)
        del q, k, v, s, out, want
    (q, k, v), row = serve_fa
    B, S, H, D = q.shape
    Kh = k.shape[2]
    flops = 4 * D * H * B * visible_pairs(S, 0, None)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kt, vt = kt.repeat_interleave(H // Kh, 1), vt.repeat_interleave(H // Kh, 1)
    report["flash_attention"].update(
        max_abs_err=row["max_abs_err"], tol=row["tol"], rtol=row["rtol"],
        **timings(torch, lambda: ops.flash_attention(q, k, v),
                  lambda: ref.flash_attention_ref(q, k, v),
                  lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True),
                  ms_reps=(5, 3), plain_reps=(3, 2)),
        **bound(nbytes, flops),
        shape=dict(B=B, S=S, H=H, Kh=Kh, D=D, causal_flops=flops))
    del qt, kt, vt

    # -- fused_sample ---------------------------------------------------------
    # tolerance 1e-3 on values and lse (logits O(1), lse ~12; both sides
    # multiply the same values in f32 -- bf16 x bf16 products are exact in
    # f32 on the tensor cores too -- only the sum order differs); indices:
    # each returned index must carry the plain logit it claims (within tol),
    # and exact ties must resolve to the lowest index.
    def fs_check(name, x, w, k, cap):
        vals, idx, lse = ops.fused_sample(x, w, top_k=k, softcap=cap)
        rv, ri, rl = ref.fused_sample_ref(x, w, top_k=k, softcap=cap)
        logits = x.float() @ w.float()
        if cap > 0:
            logits = torch.tanh(logits / cap) * cap
        claimed = torch.gather(logits, 1, idx.long())
        torch.cuda.synchronize()
        err = max(maxerr(vals, rv), maxerr(lse, rl), maxerr(claimed, vals))
        return record("fused_sample", name, err, 1e-3,
                      {"idx_equal": bool((idx == ri).all())}), (vals, idx)

    V, Dm = 151936, 1024
    g = torch.Generator(device=dev).manual_seed(3)
    embed = (torch.randn((V, Dm), generator=g, device=dev)
             / math.sqrt(Dm)).to(bf16)
    x = torch.randn((32, Dm), generator=g, device=dev).to(bf16)
    serve_row, _ = fs_check("serve_b32_tied_bf16_k1", x, embed.T, 1, 0.0)
    fs_check("serve_b32_tied_bf16_k8", x, embed.T, 8, 0.0)
    # the tensor-core kernel's edges: B around its 16-row m-tiles (33: 48
    # rows a CTA), k = 16, an untied bf16 head (v contiguous, V not a
    # multiple of 8 or of the 128-wide chunk: a (Dm, V) view of a wider
    # buffer)
    x33 = torch.randn((33, Dm), generator=g, device=dev).to(bf16)
    for b_, k_, cap_ in ((1, 16, 0.0), (16, 16, 0.0), (17, 1, 30.0),
                         (33, 8, 0.0)):
        fs_check(f"b{b_}_tied_bf16_k{k_}" + ("_softcap30" if cap_ else ""),
                 x33[:b_], embed.T, k_, cap_)
    wu16 = (torch.randn((Dm, 32008), generator=g, device=dev)
            / math.sqrt(Dm)).to(bf16)[:, :32003]
    fs_check("untied_bf16_b32_v32003_k16_softcap30", x, wu16, 16, 30.0)
    fs_check("untied_bf16_b17_v32003_k1", x33[:17], wu16, 1, 0.0)
    del x33, wu16
    xs = torch.randn((5, 64), generator=g, device=dev)
    wu = torch.randn((64, 1000), generator=g, device=dev) / 8.0
    fs_check("untied_f32_softcap30_k8", xs, wu, 8, 30.0)
    fs_check("tied_f32_v300_k4", xs, (torch.randn(
        (300, 64), generator=g, device=dev) / 8.0).T, 4, 0.0)
    # 33 rows: a second 32-row block of the chunk pass
    fs_check("b33_untied_f32_softcap30_k1", torch.randn(
        (33, 128), generator=g, device=dev), torch.randn(
        (128, 1000), generator=g, device=dev) / 8.0, 1, 30.0)
    fs_check("b2_tied_bf16_v5000_k8", xs[:2, :32].to(bf16), (torch.randn(
        (5000, 32), generator=g, device=dev) / 4.0).to(bf16).T, 8, 0.0)
    # exact ties across vocab chunks (chunk width 128): columns 37, 300, 900
    wt = torch.zeros((16, 1000), device=dev)
    wt[:, [37, 300, 900]] = 1.0
    wt[:, 5] = 0.5
    for dt in (f32, bf16):
        xt = torch.ones((2, 16), device=dev).to(dt)
        row, (vals, idx) = fs_check(f"ties_{str(dt)[6:]}_k4", xt,
                                    wt.to(dt), 4, 0.0)
        check(idx[:, :3].tolist() == [[37, 300, 900]] * 2,
              f"fused_sample ties: got {idx.tolist()}")
    es = x.element_size()
    B = x.shape[0]
    nbytes = V * Dm * es + B * Dm * es + B * 3 * 4
    flops = 2 * B * Dm * V
    w = embed.T

    def library():
        logits = torch.matmul(x, w).float()
        return torch.topk(logits, 1), torch.logsumexp(logits, -1)
    report["fused_sample"].update(
        max_abs_err=serve_row["max_abs_err"], tol=serve_row["tol"],
        **timings(torch, lambda: ops.fused_sample(x, w),
                  lambda: ref.fused_sample_ref(x, w), library),
        **bound(nbytes, flops),
        shape=dict(B=B, Dm=Dm, V=V, w="embed.T (strided)"))
    del embed, x, w
    torch.cuda.empty_cache()
    (OUT / "chip_smoke_kernel_cases.json").write_text(
        json.dumps(cases, indent=1))
    emit({"phase": "kernels", "build_s": round(build_s, 3),
          "cases": len(cases), "cases_ok": sum(c["ok"] for c in cases),
          "timing": report})


# ---------------------------------------------------------------------------
# Optional phase: design variants and ablations of the kernels
# ---------------------------------------------------------------------------

def variant_sources():
    """name -> (library, {file: text}): each a text edit of a committed
    kernel source (the library's .cu, or for the decode kernels their
    shared body) that changes one design choice or removes one part (the
    ablations compute wrong results on purpose and are only timed)."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    fa = (csrc / "flash_attention.cu").read_text()
    fs = (csrc / "fused_sample.cu").read_text()
    pd = (csrc / "paged_decode_attention.cu").read_text()
    body = (csrc / "decode_attention.cuh").read_text()

    def sub(src, *pairs):
        for a, b in pairs:
            if a not in src:
                raise ValueError(f"variant edit not found: {a[:60]!r}")
            src = src.replace(a, b)
        return src

    def decode(*pairs):
        return ("paged_decode_attention",
                {"paged_decode_attention.cu": pd,
                 "decode_attention.cuh": sub(body, *pairs)})
    cfg = "kFlashWarps = 4, kFlashMT = 1, kFlashStages = 2"
    qk = "          mma_bf16(sc[mt][2 * p{}], qa[mt], kf[{}], kf[{}]);\n"
    pv = "          mma_bf16(o[mt][2 * p{}], pa[mt], vf[{}], vf[{}]);\n"
    split = "kDecodeSplitRows = 256"
    ring = "kDecodeStages = 4"
    scores = ("      score_tile<KV, D, G, kQReg, QR>(st, it * TR, nk, qr, qs, sc,"
              " ksr,\n                                      p.softcap, lane,"
              " warp);\n")
    pvs = "      pv_tile<KV, D, G>(st, (it - ntiles) * TR, nk, sc, acc, tid);\n"
    return {
        "flash_attention/shipped": ("flash_attention", {
            "flash_attention.cu": fa}),
        "flash_attention/2_mtiles_a_warp": ("flash_attention", {
            "flash_attention.cu": sub(
                fa, (cfg, cfg.replace("kFlashMT = 1", "kFlashMT = 2")))}),
        "flash_attention/3_stage_ring": ("flash_attention", {
            "flash_attention.cu": sub(
                fa, (cfg, cfg.replace("kFlashStages = 2",
                                      "kFlashStages = 3")))}),
        "flash_attention/ablate_qk_product": ("flash_attention", {
            "flash_attention.cu": sub(fa, (qk.format("", 0, 1), ""),
                                      (qk.format(" + 1", 2, 3), ""))}),
        "flash_attention/ablate_pv_product": ("flash_attention", {
            "flash_attention.cu": sub(fa, (pv.format("", 0, 1), ""),
                                      (pv.format(" + 1", 2, 3), ""))}),
        "flash_attention/ablate_exp": ("flash_attention", {
            "flash_attention.cu": sub(
                fa, ("fast_exp2(fmaf(sc[mt][j][e], mul, -ms))",
                     "fmaf(sc[mt][j][e], mul, -ms)"))}),
        "fused_sample/shipped": ("fused_sample", {"fused_sample.cu": fs}),
        "fused_sample/6_stage_ring": ("fused_sample", {
            "fused_sample.cu": sub(fs, ("kStages = 4", "kStages = 6"))}),
        "fused_sample/8_stage_ring": ("fused_sample", {
            "fused_sample.cu": sub(fs, ("kStages = 4", "kStages = 8"))}),
        "paged_decode/shipped": decode(),
        "paged_decode/split_128_rows": decode(
            (split, split.replace("256", "128"))),
        "paged_decode/split_512_rows": decode(
            (split, split.replace("256", "512"))),
        "paged_decode/2_stage_ring": decode((ring, ring.replace("4", "2"))),
        "paged_decode/3_stage_ring": decode((ring, ring.replace("4", "3"))),
        "paged_decode/ablate_scores": decode((scores, "")),
        "paged_decode/ablate_pv": decode((pvs, "")),
    }


def serve_decode_lens():
    """kv_len of the 32 slots of the decode kernels' serve shape."""
    import numpy as np
    rng = np.random.RandomState(11)
    return (rng.randint(64, 1025, size=32)
            + rng.randint(0, 129, size=32)).tolist()


def phase_variants(torch, dev):
    """Build every variant in parallel, then time each through its C
    entry point (no wrapper; ``ms`` with CUDA events back to back,
    ``kernel_ms`` the device time of its launches) on the serve shapes'
    inputs, with its max error against the plain version."""
    import ctypes
    from repro_torch.kernels import build, ref
    vdir = build.BUILD_DIR / "variants"
    procs = {}
    for name, (lib, files) in variant_sources().items():
        d = vdir / name.replace("/", "__")
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        procs[name] = (lib, d, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(d / "lib.so"), str(d / f"{lib}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, H, Kh, D = 8, 1024, 16, 8, 128
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, Kh, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, Kh, D), generator=g, device=dev).bfloat16()
    fa_want = ref.flash_attention_ref(q, k, v)
    fa_out = torch.empty_like(q)
    V, Dm, Bs = 151936, 1024, 32
    embed = (torch.randn((V, Dm), generator=g, device=dev)
             / math.sqrt(Dm)).bfloat16()
    x = torch.randn((Bs, Dm), generator=g, device=dev).bfloat16()
    w = embed.T
    fs_want = ref.fused_sample_ref(x, w)
    # decode serve shape, fp and int8 pages (with the slots' new rows)
    dq, dkp, dvp, dbt, dkv = paged_inputs(torch, dev, torch.bfloat16,
                                          serve_decode_lens(), 16, 8, 128)
    _, k8, v8, ks8, vs8, _, _ = int8_inputs(ref, (dq, dkp, dvp, dbt, dkv))
    kn, vn = (torch.randn((32, 8, 128), generator=g, device=dev).bfloat16()
              for _ in range(2))
    dec_want = {
        "fp": ref.paged_decode_attention_ref(dq, dkp, dvp, dbt, dkv),
        "int8": ref.paged_decode_attention_int8_ref(
            dq, k8, v8, ks8, vs8, dbt, dkv, k_new=kn, v_new=vn)}
    dec_in = {"fp": (dkp, dvp, None, None, None, None, 1),
              "int8": (k8, v8, ks8, vs8, kn, vn, 2)}
    dec_out = torch.empty_like(dq)
    nb = dbt.shape[1]
    rows = {}
    for name, (lib, d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            check(False, f"variant {name}: nvcc failed\n{log[-2000:]}")
            continue
        so = ctypes.CDLL(str(d / "lib.so"))
        calls = {}
        if lib == "flash_attention":
            fn = so.flash_attention
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

            def call():
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                          fa_out.data_ptr(), B, S, H, Kh, D, 0, 0.0, 1,
                          stream)

            def err():
                return float((fa_out.float() - fa_want.float()).abs().max())
            calls[name] = (call, err, r"flash_tc_kernelILi128E")
        elif lib == "fused_sample":
            fn = so.fused_sample
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                           + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            so.fused_sample_partials.argtypes = [ctypes.c_int] * 2
            npart = so.fused_sample_partials(V, 1)
            outs = [torch.empty((Bs, 1), device=dev),
                    torch.empty((Bs, 1), dtype=torch.int32, device=dev),
                    torch.empty((Bs, 1), device=dev),
                    torch.empty((Bs, npart), device=dev),
                    torch.empty((Bs, npart), device=dev),
                    torch.empty((Bs, npart, 1), device=dev),
                    torch.empty((Bs, npart, 1), dtype=torch.int32,
                                device=dev)]

            def call():
                return fn(x.data_ptr(), w.data_ptr(), w.stride(0),
                          w.stride(1), *[t.data_ptr() for t in outs], Bs, Dm,
                          V, 1, 0.0, 1, stream)

            def err():
                return max(float((outs[0] - fs_want[0]).abs().max()),
                           float((outs[2] - fs_want[2]).abs().max()))
            calls[name] = (call, err, r"sample_tc_kernelILi2ELb1E")
        else:
            fn = so.paged_decode_attention
            fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            so.paged_decode_splits.argtypes = [ctypes.c_int] * 2
            ml, acc = build.split_scratch(so.paged_decode_splits(nb, 16), 32,
                                          16, 128, dev)
            for kind, (kp_, vp_, ks_, vs_, kn_, vn_, code) in dec_in.items():
                def call(kp_=kp_, vp_=vp_, ks_=ks_, vs_=vs_, kn_=kn_,
                         vn_=vn_, code=code):
                    return fn(dq.data_ptr(), kp_.data_ptr(), vp_.data_ptr(),
                              *[build.data_ptr(t) for t in (ks_, vs_, kn_,
                                                            vn_)],
                              dbt.data_ptr(), dkv.data_ptr(),
                              dec_out.data_ptr(), build.data_ptr(ml),
                              build.data_ptr(acc), 32, 16, 8, 128, 16, nb,
                              0.0, 1, code, stream)

                def err(kind=kind):
                    return float((dec_out.float()
                                  - dec_want[kind].float()).abs().max())
                calls[f"{name}/{kind}"] = (
                    call, err, r"decode_split_kernelI13__nv_bfloat16"
                    + ("S" if kind == "fp" else "a") + r"\w*Li128ELi2E")
        for row_name, (call, err, pat) in calls.items():
            rc = call()
            torch.cuda.synchronize()
            check(rc == 0, f"variant {row_name}: launch failed with {rc}")
            regs = ptxas_functions(log, pat)
            rows[row_name] = {
                "rc": rc, "max_abs_err": err(),
                "ms": cuda_ms(torch, call) if rc == 0 else None,
                "kernel_ms": device_ms(torch, call)[0] if rc == 0 else None,
                "registers": max((v["registers"] or 0
                                  for v in regs.values()), default=None),
                "spill_bytes": sum(v["spill_bytes"] or 0
                                   for v in regs.values())}
    emit({"phase": "variants",
          "shapes": {"flash_attention": dict(B=B, S=S, H=H, Kh=Kh, D=D),
                     "fused_sample": dict(B=Bs, Dm=Dm, V=V, w="embed.T"),
                     "paged_decode": dict(B=32, H=16, Kh=8, D=128, P=16,
                                          nb=nb, live_rows=int(dkv.sum()),
                                          q="bfloat16")},
          "variants": rows})


# ---------------------------------------------------------------------------
# Phase 2: serve Qwen3-0.6B
# ---------------------------------------------------------------------------

def make_requests(n_groups, group, lo, hi, vocab, seed, start_uid=0):
    import numpy as np
    from repro_torch.core.buffer import BufferEntry
    rng = np.random.RandomState(seed)
    out = []
    for gi in range(n_groups):
        plen = int(rng.randint(lo, hi + 1))
        prompt = rng.randint(1, vocab, size=plen).tolist()
        for j in range(group):
            out.append(BufferEntry(uid=start_uid + gi * group + j,
                                   prompt=list(prompt)))
    return out


def serve_loop(engine, queue, outputs, step_ms, profile=None):
    """Continuous batching (examples/serve_batch.py): refill free slots,
    then step.  ``profile`` (a dict with "at" and "steps") traces that many
    decode steps from step "at" with torch.profiler and fills in the
    device's busy time and the kernels that took it."""
    steps = 0
    while queue or engine.active_uids():
        free = engine.free_slots()
        if free and queue:
            engine.submit(queue[:free], 0)
            queue = queue[free:]
        if profile is not None and steps == profile["at"]:
            profile.update(profile_steps(engine, profile["steps"], outputs))
            steps += profile["steps"]
            continue
        t = time.perf_counter()
        evs = engine.step()
        step_ms.append(1e3 * (time.perf_counter() - t))
        for ev in evs:
            outputs.setdefault(ev.uid, []).append((ev.token, ev.logprob))
        steps += 1
    return steps


def profile_call(torch, fn):
    """One call of ``fn`` under torch.profiler: its wall time, the summed
    device time of its CUDA kernels, their count and the costliest."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(r.self_device_time_total for r in rows) / 1e3
    top = sorted(rows, key=lambda r: -r.self_device_time_total)[:8]
    return {"wall_ms": wall, "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall if dev_ms else "not measured",
            "kernel_launches": sum(r.count for r in rows),
            "top_kernels_ms": {r.key[:60]: r.self_device_time_total / 1e3
                               for r in top}}


def profile_steps(engine, n, outputs):
    """Device busy share of ``n`` decode steps (no submits in between):
    the summed time of the CUDA kernels over the steps' wall time, from
    torch.profiler; the wall time includes the profiler's own overhead."""
    import torch

    def steps():
        for _ in range(n):
            for ev in engine.step():
                outputs.setdefault(ev.uid, []).append((ev.token, ev.logprob))
    p = profile_call(torch, steps)
    return {"wall_ms_per_step": p["wall_ms"] / n,
            "device_ms_per_step": p["device_ms"] / n,
            "device_busy_share": p["device_busy_share"],
            "kernel_launches_per_step": p["kernel_launches"] / n,
            "top_kernels_ms_per_step": {k: v / n for k, v
                                        in p["top_kernels_ms"].items()}}


def check_launches(path, counts, expected):
    """Every kernel in ``expected`` launched exactly that many times on
    the path, and no other kernel launched at all."""
    want = {name: expected.get(name, 0) for name in counts}
    check(counts == want, f"{path}: launches {counts} != expected {want}")


def run_path(torch, ops, engine, reqs, profile=None):
    """Serve ``reqs`` with launch counts zeroed just before and read just
    after; returns (outputs, summary)."""
    outputs, step_ms = {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    steps = serve_loop(engine, list(reqs), outputs, step_ms, profile)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    tokens = sum(len(v) for v in outputs.values())
    ms = sorted(step_ms)
    return outputs, {
        "requests": len(outputs), "tokens": tokens, "steps": steps,
        "prefill_launches": engine.prefill_launches, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "decode_step_ms_median": statistics.median(ms),
        "decode_step_ms_p90": ms[int(0.9 * (len(ms) - 1))],
        "launches": counts,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_answers(path, outputs, n, vocab):
    check(len(outputs) == n and all(len(v) >= 1 for v in outputs.values()),
          f"{path}: not every request answered")
    check(all(math.isfinite(lp) and 0 <= t < vocab
              for v in outputs.values() for t, lp in v),
          f"{path}: token out of range or non-finite logprob")


def phase_serve(torch, dev, launches, keep):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.rollout.engine import SlotEngine

    cfg = get_config("qwen3_0_6b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    eos = 151645
    nl = cfg.num_layers
    kw = dict(capacity=32, max_total_len=2048, max_gen_len=128, eos_id=eos,
              pad_id=0)
    paths = {}

    # main path: paged fp pool, fused greedy head
    engine = SlotEngine(model, lambda: params, fused_sampling=True,
                        temperature=0.0, **kw)
    reqs = make_requests(24, 4, 64, 1024, cfg.vocab_size, seed=1)
    prompts = {e.uid: list(e.prompt) for e in reqs}
    outputs, main = run_path(torch, ops, engine, reqs)
    launches["main"] = main["launches"]
    stats = engine.cache_stats()
    check_answers("serve", outputs, 96, cfg.vocab_size)
    check_launches("serve", main["launches"], {
        "paged_decode_attention": nl * main["steps"],
        "flash_attention": nl * engine.prefill_launches,
        "fused_sample": main["steps"]})
    check(stats["prefill_tokens_saved"] > 0, "serve: no prefix sharing")
    keep["serve"] = {u: (prompts[u], outputs[u]) for u in range(4)}
    main["cache_stats"] = stats
    paths["main"] = main
    del engine
    torch.cuda.empty_cache()

    # the dense layout: one (L, 32, 2048, Kh, D) cache, no sharing
    dense = SlotEngine(model, lambda: params, paged=False, temperature=0.0,
                       **kw)
    reqs = make_requests(8, 4, 64, 1024, cfg.vocab_size, seed=4,
                         start_uid=3000)
    prompts = {e.uid: list(e.prompt) for e in reqs}
    out_d, summ = run_path(torch, ops, dense, reqs)
    launches["dense"] = summ["launches"]
    check_answers("serve_dense", out_d, 32, cfg.vocab_size)
    check_launches("serve_dense", summ["launches"], {
        "ragged_decode_attention": nl * summ["steps"],
        "flash_attention": nl * dense.prefill_launches})
    check(dense.cache_stats() is None, "serve_dense: cache_stats not None")
    summ["cache_gb"] = sum(a.numel() * a.element_size()
                           for a in dense.cache.values()) / 1e9
    keep["serve_dense"] = {u: (prompts[u], out_d[u])
                           for u in sorted(out_d)[:4]}
    paths["dense"] = summ
    del dense
    torch.cuda.empty_cache()

    # int8 KV pages, oversubscribed: 48 requests through 32 slots
    q8 = SlotEngine(model, lambda: params, kv_quant="int8",
                    fused_sampling=True, temperature=0.0, **kw)
    reqs = make_requests(12, 4, 64, 1024, cfg.vocab_size, seed=5,
                         start_uid=4000)
    out_8, summ = run_path(torch, ops, q8, reqs)
    launches["int8"] = summ["launches"]
    st8 = q8.cache_stats()
    check_answers("serve_int8", out_8, 48, cfg.vocab_size)
    check_launches("serve_int8", summ["launches"], {
        "paged_decode_attention_int8": nl * summ["steps"],
        "flash_attention": nl * q8.prefill_launches,
        "fused_sample": summ["steps"]})
    check(st8["cow_copies"] > 0, "serve_int8: no copy-on-write")
    check(st8["prefill_tokens_saved"] > 0, "serve_int8: no prefix sharing")
    pool = sum(a.numel() * a.element_size() for a in q8.cache.values())
    scales = sum(a.numel() * a.element_size() for a in q8.kv_scales.values())
    bf16_pool = sum(a.numel() for a in q8.cache.values()) * 2
    summ.update(cache_stats=st8, num_pages=q8.num_pages,
                pool_gb={"int8": pool / 1e9, "scales": scales / 1e9,
                         "bf16_same_pages": bf16_pool / 1e9})
    paths["int8"] = summ
    del q8
    torch.cuda.empty_cache()

    # one packed-prefill wave (segment-masked flash prefill); 4 of its
    # decode steps are traced
    packed = SlotEngine(model, lambda: params, fused_sampling=True,
                        temperature=0.0, packed_prefill=True, **kw)
    wave = make_requests(8, 4, 64, 1024, cfg.vocab_size, seed=2,
                         start_uid=1000)
    prof = {"at": 64, "steps": 4}
    out_p, summ = run_path(torch, ops, packed, wave, prof)
    launches["packed"] = summ["launches"]
    check(packed.prefill_launches == 1 and len(out_p) == 32,
          f"packed wave: {packed.prefill_launches} prefill launches")
    check_launches("packed", summ["launches"], {
        "paged_decode_attention": nl * summ["steps"],
        "flash_attention": nl, "fused_sample": summ["steps"]})
    summ["decode_profile"] = prof
    paths["packed"] = summ
    del packed
    torch.cuda.empty_cache()

    # a few sampled steps (temperature 1.0: the plain head + multinomial)
    sampled = SlotEngine(model, lambda: params, fused_sampling=True,
                         temperature=1.0, seed=5, **kw)
    ops.reset_launch_counts()
    sampled.submit(make_requests(2, 4, 64, 512, cfg.vocab_size, seed=3,
                                 start_uid=2000), 0)
    evs = [ev for _ in range(8) for ev in sampled.step()]
    torch.cuda.synchronize()
    launches["sampled"] = ops.launch_counts()
    check(len(evs) == 64 and all(math.isfinite(ev.logprob)
                                 and 0 <= ev.token < cfg.vocab_size
                                 for ev in evs), "sampled steps")
    check_launches("sampled", launches["sampled"], {
        "paged_decode_attention": nl * 8,
        "flash_attention": nl * sampled.prefill_launches})
    del sampled
    torch.cuda.empty_cache()

    emit({"phase": "serve", "model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "dtype": "bfloat16",
          "paths": paths, "sampled_steps": {"events": len(evs)}})
    return model, params


# ---------------------------------------------------------------------------
# Phase 3: end-to-end against the plain forward
# ---------------------------------------------------------------------------

def score(torch, model, params, prompt, gen):
    """Per generated token: (argmax, logprob of the token, max logprob)
    from the plain full-sequence forward on prompt + generated tokens."""
    from repro_torch.models import transformer as TF
    toks = torch.tensor([list(prompt) + [t for t, _ in gen]],
                        device=model.device)
    with torch.no_grad():
        logits, _ = TF.forward(params, model.cfg, toks)
    n = len(prompt)
    lp = torch.log_softmax(logits[0, n - 1:n - 1 + len(gen)].float(), -1)
    want = torch.tensor([t for t, _ in gen], device=lp.device)
    return (lp.argmax(-1).tolist(), lp.gather(1, want[:, None])[:, 0].tolist(),
            lp.max(-1).values.tolist())


def near_tie_check(torch, model, params, served, tol):
    """Served (prompt, [(token, logprob)]) against the plain forward: max
    logprob error, argmax flips, and flips beyond a near-tie of ``tol``
    (the forward's best token ahead of the served one by more than tol)."""
    err, total, flips, bad, n = 0.0, 0.0, 0, 0, 0
    for prompt, gen in served.values():
        am, lp, mx = score(torch, model, params, prompt, gen)
        for a, l, m, (t, lt) in zip(am, lp, mx, gen):
            n += 1
            err = max(err, abs(l - lt))
            total += abs(l - lt)
            if a != t:
                flips += 1
                bad += (m - l) > tol
    return {"requests": len(served), "tokens": n, "argmax_flips": flips,
            "flips_beyond_tol": bad, "max_logprob_err": err,
            "mean_logprob_err": total / max(n, 1), "tol": tol}


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def phase_e2e(torch, dev, keep, bf16_model, bf16_params):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    from repro_torch.rollout.engine import SlotEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen3_0_6b").replace(
        num_layers=4, param_dtype=torch.float32, compute_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(7))
    reqs = make_requests(3, 2, 20, 700, cfg.vocab_size, seed=4)
    prompts = {e.uid: list(e.prompt) for e in reqs}
    kw = dict(capacity=8, max_total_len=2048, max_gen_len=24, eos_id=-1,
              temperature=0.0)
    outs = {}
    for name, opts in (("paged", {"fused_sampling": True}),
                       ("dense", {"paged": False}),
                       ("int8", {"kv_quant": "int8", "fused_sampling": True})):
        eng = SlotEngine(model, lambda: params, **kw, **opts)
        outs[name] = {}
        serve_loop(eng, list(reqs), outs[name], [])
        del eng
        torch.cuda.empty_cache()

    # fp engines, paged and dense: greedy tokens identical to each other and
    # to the plain forward's argmax, logprobs within 1e-3 of the forward
    f32 = {}
    for name in ("paged", "dense"):
        mism, err = 0, 0.0
        for uid, gen in outs[name].items():
            am, lp, _ = score(torch, model, params, prompts[uid], gen)
            mism += sum(a != t for a, (t, _) in zip(am, gen))
            err = max(err, max(abs(a - l) for a, (_, l) in zip(lp, gen)))
        check(mism == 0, f"e2e f32 {name}: {mism} tokens differ")
        check(err <= 1e-3, f"e2e f32 {name}: logprob err {err}")
        f32[name] = {"requests": len(outs[name]),
                     "tokens": sum(len(v) for v in outs[name].values()),
                     "token_mismatches": mism, "max_logprob_err": err,
                     "tol": 1e-3}
    same = all([t for t, _ in outs["dense"][u]] == [t for t, _ in g]
               for u, g in outs["paged"].items())
    check(same, "e2e f32: dense and paged greedy streams differ")
    f32["dense_equals_paged"] = same

    # int8 pages are lossy by design, so the fp forward bounds them only
    # loosely; the tight check is the same engine on CPU tensors, i.e. the
    # plain versions (whose greedy streams equal the reference's int8
    # engine in tests/test_torch_engine.py), on the same weights and
    # requests:
    # - the first generated token of every request equals the fp engine's
    #   (it decodes off freshly quantised prefill pages);
    # - card against CPU: tokens equal up to a first divergence, and there
    #   only at a near-tie of the fp forward (0.05 nats); logprobs before
    #   it within 0.05 nats.  Both attend in the same order, but the card
    #   computes K/V and the attention in another f32 sum order, which
    #   can tip a cell at an int8 rounding tie to the next step, and
    #   over 24 steps of a 4-layer model such cells add up;
    # - against the fp forward: no farther than the CPU run of the same
    #   engine, plus those 0.05 nats.
    first = sum(outs["int8"][u][0][0] == g[0][0]
                for u, g in outs["paged"].items())
    check(first == len(reqs), f"e2e f32 int8: first token differs from fp "
          f"in {len(reqs) - first} of {len(reqs)} requests")
    cpu_eng = SlotEngine(build_model(cfg, device="cpu"),
                         lambda p=to_cpu(params): p, kv_quant="int8",
                         fused_sampling=True, **kw)
    outs["int8_cpu"] = {}
    t0 = time.perf_counter()
    serve_loop(cpu_eng, list(reqs), outs["int8_cpu"], [])
    cpu_s = time.perf_counter() - t0
    del cpu_eng
    agree, diverged, bad, lp_gap = 0, 0, 0, 0.0
    for uid, want in outs["int8_cpu"].items():
        got = outs["int8"][uid]
        n = next((i for i, (a, b) in enumerate(zip(want, got))
                  if a[0] != b[0]), None)
        same = len(want) if n is None else n
        lp_gap = max([lp_gap] + [abs(a[1] - b[1]) for a, b
                                 in zip(want[:same], got[:same])])
        if n is None:
            agree += len(want) == len(got)
            continue
        diverged += 1
        _, lps, _ = score(torch, model, params, prompts[uid], got[:n + 1])
        _, lpw, _ = score(torch, model, params, prompts[uid], want[:n + 1])
        bad += abs(lps[n] - lpw[n]) > 0.05
    check(agree + diverged == len(reqs) and bad == 0 and lp_gap <= 0.05,
          f"e2e f32 int8 card vs CPU: {bad} divergences beyond a near-tie, "
          f"logprob gap {lp_gap}")
    i8 = near_tie_check(torch, model, params,
                        {u: (prompts[u], g) for u, g in outs["int8"].items()},
                        0.05)
    i8_cpu = near_tie_check(
        torch, model, params,
        {u: (prompts[u], g) for u, g in outs["int8_cpu"].items()}, 0.05)
    tol = i8_cpu["max_logprob_err"] + 0.05
    check(i8["max_logprob_err"] <= tol,
          f"e2e f32 int8: logprob err {i8['max_logprob_err']} > {tol}")
    i8.update(tol=tol, first_token_equal_fp=first,
              cpu={"max_logprob_err": i8_cpu["max_logprob_err"],
                   "mean_logprob_err": i8_cpu["mean_logprob_err"],
                   "streams_equal": agree, "diverged_at_near_tie": diverged,
                   "max_logprob_gap_to_card": lp_gap, "seconds": cpu_s})
    f32["int8"] = i8
    del params
    torch.cuda.empty_cache()

    # bf16, 28 layers, 4 requests each of the main and the dense serve
    # paths.  Tolerance 0.1 nats: the engine's cached K/V, its f32-softmax
    # kernels and its fused head round at other points than one bf16
    # forward over the whole sequence (each bf16 rounding is 2^-9
    # relative, over 28 layers of residual updates); a token may differ
    # from the forward's argmax only where the forward itself has a
    # near-tie within that tolerance.
    bf = {}
    for name in ("serve", "serve_dense"):
        bf[name] = near_tie_check(torch, bf16_model, bf16_params, keep[name],
                                  0.1)
        check(bf[name]["max_logprob_err"] <= 0.1,
              f"e2e bf16 {name}: logprob err {bf[name]['max_logprob_err']}")
        check(bf[name]["flips_beyond_tol"] == 0,
              f"e2e bf16 {name}: {bf[name]['flips_beyond_tol']} tokens "
              "differ beyond a near-tie of 0.1")
    emit({"phase": "e2e", "f32_4layer": f32, "bf16_28layer": bf})


# ---------------------------------------------------------------------------
# Phase 4: the RL loop (rollout on the kernels; plain forward + autograd)
# ---------------------------------------------------------------------------

RL_EOS = 151645            # Qwen3's <|im_end|>
# Random weights give each of the 151,936 ids about the same probability,
# so a sequence would almost never end before max_gen_len and every slot
# would finish on the same step; a trained policy's lengths vary, and
# SortedRL schedules around that variance.  The random model's final
# normed hidden states share a direction (their mean has a third of their
# norm), so the rl phase sets EOS's (tied) embedding row along it, long
# enough that EOS's logit averages RL_EOS_LOGIT over the prompts (the
# others' are ~N(0, 1)): about 1% of the steps end a sequence, and the
# row is about as long as a random row, so EOS's logit carries no more
# bf16 error than the others'.
RL_EOS_LOGIT = 8.5


def rl_reward(toks, meta):
    """Deterministic reward over the generated ids (random Qwen3 weights
    emit ids far outside any task's vocabulary): 0, 0.5 or 1 by the ids'
    sum, so rewards differ inside a GRPO group."""
    del meta
    return (sum(toks) % 3) / 2.0


def rl_prompts(n_groups, group, lo, hi, vocab, seed):
    """GRPO groups: ``group`` copies of one prompt of ``lo``..``hi`` ids,
    the group's index as ``prompt_id``."""
    import types
    import numpy as np
    rng = np.random.RandomState(seed)
    prompts, metas = [], []
    for gi in range(n_groups):
        p = rng.randint(1, vocab, size=int(rng.randint(lo, hi + 1))).tolist()
        prompts += [list(p) for _ in range(group)]
        metas += [types.SimpleNamespace(prompt_id=gi)] * group
    return prompts, metas


def leaf_paths(tree, prefix=""):
    """(path, tensor) in ``tree_leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaf_paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def final_hidden(torch, model, params, prompts):
    """The final normed hidden state (f32) at every position of
    ``prompts``, from one plain forward (no kernels): (positions, d)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    cfg, dev = model.cfg, model.device
    lens = [len(p) for p in prompts]
    toks = torch.zeros((len(prompts), max(lens)), dtype=torch.long,
                       device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    pos = torch.arange(toks.shape[1], device=dev).expand(*toks.shape)

    def attend(q, k, v):
        return L.full_attention(q, k, v, causal=True)
    with torch.no_grad():
        x = TF.embed_tokens(params, cfg, toks)
        for i in range(cfg.num_layers):
            x, _, _ = TF._block(TF.layer(params, i), cfg, x, pos, attend)
        h = L.norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
        return torch.cat([h[i, :n].float() for i, n in enumerate(lens)])


def set_eos_row(torch, model, params, prompts):
    """EOS's embedding row along the mean of the final normed hidden state
    over ``prompts`` (one plain forward), scaled so that EOS's logit
    averages ``RL_EOS_LOGIT`` there.  Returns what it measured."""
    h = final_hidden(torch, model, params, prompts)
    with torch.no_grad():
        mean = h.mean(0)
        u = mean / mean.norm()
        along = float((h @ u).mean())
        row = u * (RL_EOS_LOGIT / along)
        params["embed"][RL_EOS] = row.to(params["embed"].dtype)
    return {"hidden_norm": float(h.norm(dim=-1).mean()),
            "mean_hidden_norm": float(mean.norm()),
            "eos_row_norm": float(row.norm()), "eos_logit_mean": RL_EOS_LOGIT}


def set_eos_row_greedy(torch, model, params, seqs, starts, rate):
    """EOS's embedding row for greedy decoding: along the same mean
    direction as ``set_eos_row``, scaled so that EOS would be the argmax
    (its logit beats the best other id's) at a share ``rate`` of the
    positions of ``seqs`` from ``starts`` on: greedy continuations whose
    per-step chance of ending is about ``rate``, so lengths vary.  Returns
    what it measured."""
    from repro_torch.models import transformer as TF
    h = final_hidden(torch, model, params, seqs)
    keep, at = [], 0
    for seq, start in zip(seqs, starts):
        keep.extend(range(at + start, at + len(seq)))
        at += len(seq)
    h = h[torch.tensor(keep, device=h.device)]
    with torch.no_grad():
        mean = h.mean(0)
        u = mean / mean.norm()
        along = h @ u
        w = TF.head_weight(params, model.cfg).float()
        best = []
        for chunk in h.split(512):
            logits = chunk @ w
            logits[:, RL_EOS] = float("-inf")
            best.append(logits.max(-1).values)
        best = torch.cat(best)
        # EOS wins where scale * along > best: the `rate` quantile of
        # best / along (never where along <= 0)
        ratio = torch.where(along > 0, best / along,
                            torch.full_like(best, float("inf")))
        scale = float(torch.quantile(ratio, rate))
        row = u * scale
        params["embed"][RL_EOS] = row.to(params["embed"].dtype)
    return {"positions": int(h.shape[0]), "rate": rate,
            "eos_row_norm": float(row.norm()),
            "best_other_logit_mean": float(best.mean()),
            "eos_logit_mean": float((along * scale).mean())}


def card_name_and_power():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = smi.stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def moved_after_first_update(torch, before, trainer):
    """Every parameter leaf moved, or AdamW's whole step on it rounds back
    to its bf16 value: a norm scale of 1.0 moves by lr = 1e-5, under half
    of bf16's spacing there (2^-8).  The step is recomputed from the
    optimizer's f32 moments with the reference's formula, so a leaf that
    should have moved and did not fails; so does one that no gradient
    reached (zero first moment)."""
    opt, st = trainer.opt_cfg, trainer.state.opt_state
    b1c = 1 - opt.b1 ** st.step.float()
    b2c = 1 - opt.b2 ** st.step.float()
    lr = torch.tensor(opt.lr, dtype=torch.float32, device=st.step.device)
    out = {"moved": [], "step_under_half_ulp": [], "bad": []}
    for (path, new), old, m, v in zip(leaf_paths(trainer.params()), before,
                                      leaf_paths(st.m), leaf_paths(st.v)):
        m, v = m[1], v[1]
        if not bool((m != 0).any()):
            out["bad"].append(f"{path}: no gradient")
        elif bool((new != old).any()):
            out["moved"].append(path)
        else:
            delta = (m / b1c) / (torch.sqrt(v / b2c) + opt.eps)
            want = (old.float() - lr * delta).to(old.dtype)
            out["step_under_half_ulp" if torch.equal(want, old)
                else "bad"].append(path)
    return out


def phase_rl(torch, dev, model, params, launches):
    """Qwen3-0.6B at full width and depth (bf16, the serve phase's random
    weights): the paged SlotEngine rolls out GRPO groups at temperature 1
    under the sorted policy in partial mode, and RLTrainer updates the
    weights the engine reads (PPO-clip, GRPO advantages, AdamW)."""
    from repro_torch.core.buffer import Mode, StatefulRolloutBuffer
    from repro_torch.core.orchestrator import (RolloutOrchestrator,
                                               SortedRLConfig)
    from repro_torch.core.policy import make_policy
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.rl.losses import token_logprobs
    from repro_torch.rl.trainer import RLTrainer, entries_to_batch, \
        make_trainer
    from repro_torch.rollout.engine import SlotEngine
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves, \
        tree_map

    cfg = model.cfg
    nl = cfg.num_layers
    max_total, update_batch = 384, 16
    prompts, metas = rl_prompts(16, 4, 64, 192, cfg.vocab_size, seed=6)
    eos_row = set_eos_row(torch, model, params, prompts[::4])
    trainer = RLTrainer(model, params, rl_reward,
                        opt_cfg=AdamWConfig(lr=1e-5), pad_id=0,
                        max_len=max_total, advantage_kind="grpo")
    engine = SlotEngine(model, trainer.params, capacity=32,
                        max_total_len=max_total, max_gen_len=128,
                        eos_id=RL_EOS, pad_id=0, temperature=1.0, seed=3,
                        kv_retain_across_sync=True)
    leaves = tree_leaves(trainer.params())
    ptrs = [t.data_ptr() for t in leaves]
    updates, first, step_ms, gen_lens = [], {}, [], []
    train_launches = {k: 0 for k in ops.launch_counts()}
    host_s = {"train": 0.0, "check": 0.0}
    decode_steps = [0]

    step_fn = trainer._step

    def timed_step(*a):
        """forward + backward + AdamW, between CUDA events"""
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = step_fn(*a)
        e.record()
        e.synchronize()
        step_ms.append(s.elapsed_time(e))
        return out
    trainer._step = timed_step

    engine_step = engine.step

    def counted_step():
        decode_steps[0] += bool(engine.active_uids())
        return engine_step()
    engine.step = counted_step

    def first_update_checks(req):
        """Behaviour logprobs the engine recorded (flash prefill, paged
        decode, plain head) against ``token_logprobs`` of the trainer's
        plain forward under the same weights, over the loss mask; and
        both against the same forward in f32, the bf16 noise floor."""
        batch, _ = entries_to_batch(req.entries, rl_reward, 0, max_total,
                                    "grpo", current_version=req.version,
                                    device=dev)
        old, mask = batch["old_logprobs"], batch["loss_mask"] > 0
        with torch.no_grad():
            logits, _ = model.forward(trainer.params(), batch)
            lp = token_logprobs(logits, batch["tokens"])[mask]
            del logits
            f32 = torch.float32
            m32 = build_model(cfg.replace(param_dtype=f32, compute_dtype=f32),
                              device=dev)
            p32 = tree_map(lambda t: t.float(), trainer.params())
            logits, _ = m32.forward(p32, batch)
            lp32 = token_logprobs(logits, batch["tokens"])[mask]
            del logits, p32
        eng = old[mask]
        diff = lp - eng
        return {"tokens": int(mask.sum()),
                "max_abs": float(diff.abs().max()),
                "mean_abs": float(diff.abs().mean()),
                "mean": float(diff.mean()),
                "engine_vs_f32_mean_abs": float((eng - lp32).abs().mean()),
                "trainer_vs_f32_mean_abs": float((lp - lp32).abs().mean()),
                "engine_vs_f32_max_abs": float((eng - lp32).abs().max()),
                "trainer_vs_f32_max_abs": float((lp - lp32).abs().max()),
                "versions": sorted({v for e in req.entries
                                    for v in e.versions})}

    def train_fn(req):
        torch.cuda.synchronize()
        t = time.perf_counter()
        before = None
        if not updates:
            first["logprobs"] = first_update_checks(req)
            before = [p.clone() for p in leaves]
            torch.cuda.synchronize()
            host_s["check"] += time.perf_counter() - t
            t = time.perf_counter()
        n0 = ops.launch_counts()
        result = trainer.handle(req)
        for k, n in ops.launch_counts().items():
            train_launches[k] += n - n0[k]
        torch.cuda.synchronize()
        host_s["train"] += time.perf_counter() - t
        gen_lens.extend(e.gen_len for e in req.entries)
        width = min(max_total, (max(e.total_len for e in req.entries)
                                + 31) // 32 * 32)
        rec = dict(result.metrics, entries=len(req.entries), width=width,
                   trained_tokens=sum(e.gen_len for e in req.entries),
                   stitched=sum(len(set(e.versions)) > 1
                                for e in req.entries),
                   max_token_lag=max(req.version - min(e.versions)
                                     for e in req.entries),
                   step_ms=step_ms[-1])
        updates.append(rec)
        same = (engine.params_fn() is trainer.params()
                and [t.data_ptr() for t in tree_leaves(engine.params_fn())]
                == ptrs)
        check(same, f"rl: update {len(updates)}: the engine does not read "
              "the trainer's tensors")
        if before is not None:
            first["leaves"] = moved_after_first_update(torch, before,
                                                       trainer)
            del before
        return result

    buffer = StatefulRolloutBuffer(Mode.PARTIAL)
    scfg = SortedRLConfig(mode=Mode.PARTIAL, rollout_batch=32, group_size=2,
                          update_batch=update_batch, max_gen_len=128)
    orch = RolloutOrchestrator(engine, buffer, scfg, make_policy("sorted"),
                               make_trainer("sync", fn=train_fn))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    orch.run_group(prompts, metas)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches["rl"] = counts
    rollout = {k: n - train_launches[k] for k, n in counts.items()}
    rollout_s = wall - host_s["train"] - host_s["check"]
    tokens = sum(u["trained_tokens"] for u in updates)

    check(len(updates) >= 3, f"rl: {len(updates)} updates, want >= 3")
    for i, u in enumerate(updates, 1):
        check(all(math.isfinite(v) for v in u.values()
                  if isinstance(v, float)), f"rl: update {i} not finite {u}")
        check(u["grad_norm"] > 0, f"rl: update {i}: grad_norm 0")
        if i > 1:
            # staleness is an entry's mean lag over its tokens; a stitched
            # entry's oldest token lags by at least one version
            check(u["stitched"] > 0 and u["staleness_max"] >= 1
                  and u["max_token_lag"] >= 1,
                  f"rl: update {i}: {u['stitched']} stitched entries, "
                  f"staleness_max {u['staleness_max']}, oldest token "
                  f"{u['max_token_lag']} versions behind")
    # engine against trainer: every token within 0.1 nats (the bf16
    # end-to-end tolerance) and no bias (|mean difference| <= 0.01, the
    # mean of log ratios PPO sees at the first update); the mean absolute
    # difference is bf16 noise (each path is ~0.01 nats from the f32
    # forward), so the kernel path must be no farther from the f32
    # forward than 1.25 times the trainer's own bf16 forward
    lp = first.get("logprobs", {})
    check(lp.get("versions") == [0], f"rl: first batch versions {lp}")
    check(lp.get("max_abs", 1.0) <= 0.1 and abs(lp.get("mean", 1.0)) <= 0.01
          and lp.get("engine_vs_f32_mean_abs", 1.0)
          <= 1.25 * lp.get("trainer_vs_f32_mean_abs", 0.0),
          f"rl: engine vs trainer logprobs {lp}")
    lp.update(tol_max_abs=0.1, tol_mean=0.01, tol_f32_ratio=1.25)
    lv = first.get("leaves", {"bad": ["not run"]})
    check(not lv["bad"] and lv["moved"],
          f"rl: leaves after the first update {lv}")
    check(rollout["flash_attention"] > 0
          and rollout["paged_decode_attention"] > 0,
          f"rl: rollout launches {rollout}")
    check(not any(train_launches.values()),
          f"rl: train steps launched kernels {train_launches}")
    check_launches("rl", counts, {
        "paged_decode_attention": nl * decode_steps[0],
        "flash_attention": nl * engine.prefill_launches})
    ms = sorted(u["step_ms"] for u in updates)
    emit({"phase": "rl", "model": cfg.name, "layers": nl,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "dtype": "bfloat16",
          "card": card_name_and_power(),
          "setup": {"capacity": 32, "max_total_len": max_total,
                    "max_gen_len": 128, "temperature": 1.0,
                    "policy": "sorted", "mode": "partial",
                    "rollout_batch": 32, "group_size": 2,
                    "update_batch": update_batch, "advantage": "grpo",
                    "lr": 1e-5, "prompts": len(prompts),
                    "eos_row": eos_row},
          "updates": len(updates), "rollout_tokens": tokens,
          "gen_len": {"ended_before_max": sum(n < 128 for n in gen_lens),
                      "at_max": sum(n >= 128 for n in gen_lens),
                      "mean": statistics.mean(gen_lens)},
          "rollout_s": rollout_s,
          "rollout_tokens_per_s": tokens / rollout_s,
          "decode_steps": decode_steps[0],
          "prefill_launches": engine.prefill_launches,
          "update_ms_median": statistics.median(ms), "update_ms": ms,
          "update_tokens_per_s": [
              u["entries"] * u["width"] / (u["step_ms"] / 1e3)
              for u in updates],
          "update_trained_tokens_per_s": [
              u["trained_tokens"] / (u["step_ms"] / 1e3) for u in updates],
          "wall_s": wall, "train_s": host_s["train"],
          "first_update": first, "history": updates,
          "launches": {"rollout": rollout, "train": train_launches},
          "peak_mem_gb": peak,
          "cache_stats": engine.cache_stats()})
    del engine, trainer, orch
    release(torch)


def phase_rl_session(torch, launches, extras_only=False):
    """The entry point a user calls: ``RLSession.from_config(SessionConfig(
    task="logic", engine="slot", n_groups=2, sft_steps=20)).run()`` on the
    card (the tiny f32 LM, so the kernels' f32 instantiations), to its
    end and ``final_eval``; then the same entry point with the control
    plane's options: two replicas with a kill, the ``bubble_target``
    autoscaler, the serving tier (``arrival``) and ``engine="sim"``."""
    from repro_torch.kernels import ops
    from repro_torch.rl.session import RLSession, SessionConfig

    def run(name, **kw):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        session = RLSession.from_config(SessionConfig(task="logic",
                                                      n_groups=2, **kw))
        out = session.run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        launches[name] = counts
        hist = out["history"]
        check(len(hist) >= 1 and all(
            math.isfinite(v) for h in hist for v in h.values()
            if isinstance(v, (int, float))), f"{name}: history {hist}")
        if kw.get("engine") == "sim":
            check(not any(counts.values()), f"{name}: launches {counts}")
        else:
            check(session.model.device.type == "cuda",
                  f"{name}: model on {session.model.device}")
            check(counts["flash_attention"] > 0
                  and counts["paged_decode_attention"] > 0
                  and not any(n for k, n in counts.items() if k not in
                              ("flash_attention", "paged_decode_attention")),
                  f"{name}: launches {counts}")
        return session, out, time.perf_counter() - t0, counts

    if not extras_only:
        session, out, wall, counts = run("rl_session", engine="slot",
                                         sft_steps=20)
        losses = session.sft_losses
        check(len(losses) == 20 and all(map(math.isfinite, losses))
              and losses[-1] < losses[0], f"rl_session: sft losses {losses}")
        fe = out["final_eval"]
        check(set(fe) == {"reward_mean", "solve_rate", "gen_len_mean"}
              and all(map(math.isfinite, fe.values())),
              f"rl_session: final_eval {fe}")
        emit({"phase": "rl_session", "device": str(session.model.device),
              "sft_loss_first": losses[0],
              "sft_loss_final": out["sft_loss_final"],
              "history": out["history"], "evals": out["evals"],
              "final_eval": fe, "rollout_metrics": out["rollout_metrics"],
              "run_wall_s": out["wall_time_s"], "wall_s": wall,
              "launches": counts})

    extras = {
        "rl_session_group": dict(num_replicas=2, fault_plan=[(3, 1, "kill")],
                                 sft_steps=5),
        "rl_session_autoscaler": dict(num_replicas=2, sft_steps=5,
                                      autoscaler="bubble_target"),
        "rl_session_serving": dict(
            sft_steps=5, arrival={"kind": "poisson",
                                  "rates": {"a": 20.0, "b": 10.0}},
            tenants=[{"name": "a"}, {"name": "b", "weight": 2.0}]),
        "rl_session_sim": dict(engine="sim"),
    }
    rec = {}
    for name, kw in extras.items():
        session, out, wall, counts = run(name, **kw)
        rm = out["rollout_metrics"]
        rec[name] = {"options": kw, "updates": len(out["history"]),
                     "wall_s": wall, "launches": counts,
                     "replica_deaths": rm["replica_deaths"],
                     "scale_events": rm["scale_events"],
                     "tokens_generated": rm["tokens_generated"],
                     "tenants": {n: {k: t[k] for k in ("arrivals",
                                                        "completed", "shed")}
                                 for n, t in rm.get("tenants", {}).items()}}
    check(rec["rl_session_group"]["replica_deaths"] == 1,
          f"rl_session_group: {rec['rl_session_group']}")
    for n, t in rec["rl_session_serving"]["tenants"].items():
        check(t["arrivals"] >= 1
              and t["completed"] + t["shed"] == t["arrivals"],
              f"rl_session_serving: tenant {n} {t}")
    emit({"phase": "rl_session_options", "sessions": rec})


# ---------------------------------------------------------------------------
# Phase 5: the multi-replica control plane at full width
# ---------------------------------------------------------------------------

GROUP_EOS_RATE = 0.02      # greedy positions whose argmax is EOS (group)
NEAR_TIE_BF16 = 0.1        # the e2e phase's bf16 near-tie, in nats


def release(torch) -> None:
    """Free what a phase left: the instrumented engines hold reference
    cycles (wrappers stored on the object they wrap), which only the
    cycle collector frees, and their pools with them."""
    gc.collect()
    torch.cuda.empty_cache()


def sync_clock(torch) -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def instrument_replica(torch, r, i, steps, mig):
    """Count the replica's decode steps (those that launch: an active slot)
    and time its migration calls (export -> import -> discard), each
    between device synchronisations."""
    export, accept, discard, step = (r.export_entry, r.import_entry,
                                     r.discard_entry, r.step)

    def export_entry(uid):
        t = sync_clock(torch)
        handle = export(uid)
        mig["export_s"] += sync_clock(torch) - t
        mig["exports"] += 1
        return handle

    def import_entry(handle):
        t = sync_clock(torch)
        ok = accept(handle)
        mig["import_s"] += sync_clock(torch) - t
        mig["imports"] += 1
        if ok:
            mig["imports_accepted"] += 1
            mig["pages"] += len(handle["kv"].pages)
        return ok

    def discard_entry(uid):
        mig["discards"] += 1
        discard(uid)

    def counted_step():
        steps[i] = steps.get(i, 0) + bool(r.active_uids())
        return step()
    r.export_entry, r.import_entry = export_entry, import_entry
    r.discard_entry, r.step = discard_entry, counted_step
    return r


def first_parting(want, got):
    """Index of the first token where two streams differ (a length
    difference counts at the shorter's end); None when equal."""
    for i, (a, b) in enumerate(zip(want, got)):
        if a[0] != b[0]:
            return i
    return None if len(want) == len(got) else min(len(want), len(got))


def phase_group(torch, dev, model, params, launches):
    """Two full-width replicas behind the port's EngineGroup: 16 GRPO
    groups of 4 under the sorted policy in partial mode, the
    ``least_tokens`` balancer, KV migration and a FaultInjector that kills
    replica 1 about a third of the way in; greedy fused decode, held
    against one 32-slot engine on the same prompts."""
    from repro_torch.core.buffer import BufferEntry, Mode, \
        StatefulRolloutBuffer
    from repro_torch.core.engine_api import FaultInjector
    from repro_torch.core.orchestrator import (RolloutOrchestrator,
                                               SortedRLConfig)
    from repro_torch.core.policy import make_policy
    from repro_torch.kernels import ops
    from repro_torch.rl.trainer_api import make_trainer
    from repro_torch.rollout.engine import SlotEngine
    from repro_torch.rollout.group import EngineGroup

    cfg = model.cfg
    nl = cfg.num_layers
    slots, max_total, max_gen = 16, 384, 128
    prompts, metas = rl_prompts(16, 4, 64, 192, cfg.vocab_size, seed=6)
    kw = dict(max_total_len=max_total, max_gen_len=max_gen, eos_id=RL_EOS,
              pad_id=0, temperature=0.0, fused_sampling=True)
    # calibrate EOS on the greedy continuations themselves: 32 steps of
    # each group's prompt without an EOS; until its first EOS a stream
    # walks exactly these positions, so GROUP_EOS_RATE is its per-step
    # chance of ending there
    probe = SlotEngine(model, lambda: params, capacity=16,
                       **dict(kw, eos_id=-1, max_gen_len=32))
    heads, cont = prompts[::4], {}
    serve_loop(probe, [BufferEntry(uid=i, prompt=list(p))
                       for i, p in enumerate(heads)], cont, [])
    del probe
    eos_row = set_eos_row_greedy(
        torch, model, params,
        [p + [t for t, _ in cont[i]] for i, p in enumerate(heads)],
        [len(p) - 1 for p in heads], GROUP_EOS_RATE)

    # the yardstick: one 32-slot engine serving the same prompts
    solo = SlotEngine(model, lambda: params, capacity=2 * slots, **kw)
    solo_out, solo_ms = {}, []
    t0 = time.perf_counter()
    solo_steps = serve_loop(solo, [BufferEntry(uid=i, prompt=list(p))
                                   for i, p in enumerate(prompts)],
                            solo_out, solo_ms)
    solo_s = time.perf_counter() - t0
    del solo
    torch.cuda.empty_cache()
    kill_step = max(2, solo_steps // 3)

    steps, mig = {}, {"exports": 0, "imports": 0, "imports_accepted": 0,
                      "discards": 0, "pages": 0, "export_s": 0.0,
                      "import_s": 0.0}
    replicas = [instrument_replica(
        torch, SlotEngine(model, lambda: params, capacity=slots, seed=i,
                          **kw), i, steps, mig) for i in range(2)]
    group = EngineGroup(replicas, balancer="least_tokens", migrate_kv=True,
                        fault_injector=FaultInjector([(kill_step, 1,
                                                       "kill")]))
    group_step, group_ms = group.step, []

    def timed_group_step():
        t = time.perf_counter()
        evs = group_step()              # each replica's step reads its
        group_ms.append(1e3 * (time.perf_counter() - t))   # tokens back
        return evs
    group.step = timed_group_step
    batches = []

    def train_fn(req):                  # records the batch, trains nothing
        batches.append(list(req.entries))

    scfg = SortedRLConfig(mode=Mode.PARTIAL, rollout_batch=2 * slots,
                          group_size=2, update_batch=16, max_gen_len=max_gen,
                          num_replicas=2)
    orch = RolloutOrchestrator(group, StatefulRolloutBuffer(Mode.PARTIAL),
                               scfg, make_policy("sorted"),
                               make_trainer("sync", fn=train_fn))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    orch.run_group(prompts, metas)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches["group"] = counts

    trained = [e for b in batches for e in b]
    check(sorted(e.uid for e in trained) == list(range(len(prompts))),
          "group: not every uid trained exactly once")
    st = dict(group.cache_stats())
    check(st["replica_deaths"] == 1 and st["alive_replicas"] == 1,
          f"group: replica deaths {st['replica_deaths']}")
    check(mig["exports"] >= 1 and mig["imports_accepted"] >= 1
          and mig["discards"] >= 1,
          f"group: no KV migration (export -> import -> discard) {mig}")
    decode = sum(steps.values())
    check_launches("group", counts, {
        "flash_attention": nl * sum(r.prefill_launches for r in replicas),
        "paged_decode_attention": nl * decode, "fused_sample": decode})

    # streams against the 32-slot engine; a parting must be a near-tie of
    # the plain forward (the two tokens within NEAR_TIE_BF16 nats)
    streams = {e.uid: list(zip(e.generated, e.logprobs)) for e in trained}
    equal, parted, bad, lp_gap = 0, 0, [], 0.0
    for uid, want in solo_out.items():
        got = streams[uid]
        n = first_parting(want, got)
        same = len(want) if n is None else n
        lp_gap = max([lp_gap] + [abs(a[1] - b[1])
                                 for a, b in zip(want[:same], got[:same])])
        if n is None:
            equal += 1
            continue
        parted += 1
        if n >= min(len(want), len(got)):
            bad.append((uid, n, "length"))
            continue
        _, lg, _ = score(torch, model, params, prompts[uid], got[:n + 1])
        _, lw, _ = score(torch, model, params, prompts[uid], want[:n + 1])
        if abs(lg[n] - lw[n]) > NEAR_TIE_BF16:
            bad.append((uid, n, abs(lg[n] - lw[n])))
    check(not bad, f"group: streams part from the 32-slot engine's beyond "
          f"a near-tie: {bad[:8]}")
    summary = orch.metrics.summary()
    tokens = sum(e.gen_len for e in trained)
    ms = sorted(group_ms)
    gen = [e.gen_len for e in trained]
    emit({"phase": "group", "model": cfg.name, "layers": nl,
          "dtype": "bfloat16", "card": card_name_and_power(),
          "setup": {"replicas": 2, "slots_each": slots,
                    "balancer": "least_tokens", "migrate_kv": True,
                    "kill": {"replica": 1, "group_step": kill_step},
                    "policy": "sorted", "mode": "partial",
                    "update_batch": 16, "prompts": len(prompts),
                    "max_total_len": max_total, "max_gen_len": max_gen,
                    "temperature": 0.0, "fused_sampling": True,
                    "eos_row": eos_row},
          "group_steps": len(ms), "group_step_ms_median":
          statistics.median(ms), "group_step_ms_p90":
          ms[int(0.9 * (len(ms) - 1))], "tokens": tokens,
          "tokens_per_s": tokens / wall, "wall_s": wall,
          "replica_decode_steps": steps,
          "gen_len": {"mean": statistics.mean(gen), "min": min(gen),
                      "max": max(gen), "at_max": sum(n >= max_gen
                                                     for n in gen)},
          "migration": dict(mig, steal_count=st["steal_count"],
                            steal_migrations=st["steal_migrations"],
                            migrated_pages=st["migrated_pages"],
                            rehomed_entries=st["rehomed_entries"],
                            rerolled_entries=st["rerolled_entries"]),
          "bubble_ratio": summary["bubble_ratio"],
          "replica_bubble_ratio": summary["replica_bubble_ratio"],
          "harvests": summary["harvests"], "updates": summary["updates"],
          "solo": {"steps": solo_steps, "wall_s": solo_s,
                   "decode_step_ms_median": statistics.median(solo_ms),
                   "tokens_per_s": sum(len(v) for v in solo_out.values())
                   / solo_s},
          "streams": {"equal": equal, "parted_at_near_tie": parted,
                      "beyond_near_tie": len(bad),
                      "max_logprob_gap_where_equal": lp_gap,
                      "near_tie_tol": NEAR_TIE_BF16},
          "launches": counts, "peak_mem_gb": peak,
          "cache_stats": st})
    del group, replicas, orch
    release(torch)


def phase_serve_tier(torch, dev, model, params, launches):
    """The always-on serving tier at full width: two tenants' Poisson
    arrivals (prompts of 64-512 ids) through admission-controlled queues
    into an elastic EngineGroup that starts at one replica and grows and
    sheds under the ``queue_depth`` autoscaler, on a fixed serving tick."""
    from repro_torch.core.buffer import Mode, StatefulRolloutBuffer
    from repro_torch.core.orchestrator import SortedRLConfig
    from repro_torch.kernels import ops
    from repro_torch.rl.trainer_api import make_trainer
    from repro_torch.rollout.autoscaler import Autoscaler
    from repro_torch.rollout.engine import SlotEngine
    from repro_torch.rollout.group import EngineGroup
    from repro_torch.serve import (Ingress, PoissonArrivals,
                                   ServingOrchestrator, ServingPolicy,
                                   TenantSpec)

    cfg = model.cfg
    nl = cfg.num_layers
    slots, max_total, max_gen, tick, n_arrivals = 16, 768, 128, 0.05, 64
    kw = dict(capacity=slots, max_total_len=max_total, max_gen_len=max_gen,
              eos_id=RL_EOS, pad_id=0, temperature=0.0, fused_sampling=True)
    steps, mig, built = {}, {"exports": 0, "imports": 0,
                             "imports_accepted": 0, "discards": 0,
                             "pages": 0, "export_s": 0.0,
                             "import_s": 0.0}, []

    def make_replica(idx):
        r = instrument_replica(torch, SlotEngine(model, lambda: params,
                                                 seed=idx, **kw),
                               idx, steps, mig)
        built.append(r)
        return r

    group = EngineGroup([make_replica(0)], elastic=True, migrate_kv=True,
                        spread_tenants=True)
    scale_log = []
    for name in ("scale_up", "scale_down"):
        def scaled(*a, _fn=getattr(group, name), _name=name):
            out = _fn(*a)
            torch.cuda.synchronize()
            scale_log.append({
                "action": _name, "replica": a[0] if _name == "scale_down"
                else out, "alive": sum(group.alive),
                "replicas_held": len(group.replicas),
                "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
            return out
        setattr(group, name, scaled)
    asc = Autoscaler("queue_depth", factory=make_replica, min_replicas=1,
                     max_replicas=2, window=1.0, cooldown=0.5,
                     policy_kwargs=dict(wait_frac=0.5, target_wait=0.5,
                                        idle_bubble=0.5))

    def sampler(rng, tenant):
        return [rng.randrange(1, cfg.vocab_size)
                for _ in range(rng.randint(64, 512))]
    tenants = (TenantSpec("batch", weight=1.0),
               TenantSpec("chat", weight=2.0, latency_slo=2.0))
    ingress = Ingress(tenants, PoissonArrivals(
        {"batch": 20.0, "chat": 10.0}, seed=9, prompt_sampler=sampler))
    policy = ServingPolicy(inner="sorted", admission="weighted_fair",
                           ingress=ingress)
    batches = []
    orch = ServingOrchestrator(
        group, StatefulRolloutBuffer(Mode.PARTIAL),
        SortedRLConfig(mode=Mode.PARTIAL, rollout_batch=slots, group_size=1,
                       update_batch=8, max_gen_len=max_gen),
        policy, make_trainer("sync", fn=lambda req: batches.append(
            list(req.entries))), tick=tick, autoscaler=asc)
    mem0 = torch.cuda.memory_allocated() / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    orch.run_for(n_arrivals=n_arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    launches["serve_tier"] = counts

    tenant = orch.metrics.tenant_summary()
    uids = [e.uid for b in batches for e in b]
    check(len(uids) == len(set(uids)), "serve_tier: a request trained twice")
    check(sum(t["arrivals"] for t in tenant.values()) == n_arrivals,
          f"serve_tier: arrivals {tenant}")
    for name, t in tenant.items():
        check(t["arrivals"] == t["completed"] + t["shed"]
              and t["admitted"] == t["completed"] == t["consumed"],
              f"serve_tier: tenant {name} not conserved {t}")
    check(len(uids) == sum(t["completed"] for t in tenant.values()),
          "serve_tier: completions and trained requests differ")
    check(len(asc.events) >= 1, "serve_tier: no scale event")
    decode = sum(steps.values())
    check_launches("serve_tier", counts, {
        "flash_attention": nl * sum(r.prefill_launches for r in built),
        "paged_decode_attention": nl * decode, "fused_sample": decode})
    tokens = orch.metrics.tokens_generated
    emit({"phase": "serve_tier", "model": cfg.name, "layers": nl,
          "dtype": "bfloat16", "card": card_name_and_power(),
          "setup": {"tenants": ["batch (weight 1)",
                                "chat (weight 2, latency_slo 2.0)"],
                    "rates": {"batch": 20.0, "chat": 10.0},
                    "arrivals": n_arrivals, "prompt_ids": [64, 512],
                    "tick": tick, "slots_each": slots,
                    "max_total_len": max_total, "max_gen_len": max_gen,
                    "admission": "weighted_fair", "inner": "sorted",
                    "autoscaler": "queue_depth", "replicas": [1, 2]},
          "scale_events": [dict(dataclasses.asdict(e), **m) for e, m
                           in zip(asc.events, scale_log)],
          "memory_allocated_gb_before": mem0,
          "tenants": {n: {k: t[k] for k in ("arrivals", "admitted",
                                             "completed", "shed", "tokens")}
                      for n, t in tenant.items()},
          "tokens": tokens, "tokens_per_s": tokens / wall, "wall_s": wall,
          "serving_clock_s": orch.now, "replica_decode_steps": steps,
          "migration": mig, "launches": counts,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del group, built, orch, asc
    release(torch)


# ---------------------------------------------------------------------------
# Phase 6: one long trainer step through the blockwise branch
# ---------------------------------------------------------------------------

def phase_long(torch, dev, model, params, launches):
    """The trainer's loss (``total_loss`` over ``model.forward``, PPO-clip
    on ``token_logprobs``) forward and backward at B=1, S=2304: above
    ``FULL_ATTN_MAX_SEQ``, so every layer attends blockwise (counted);
    on-policy behaviour logprobs from a no-grad forward, advantages +-1."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    from repro_torch.rl.losses import LossConfig, token_logprobs, total_loss
    from repro_torch.rl.trainer import value_and_grad

    cfg = model.cfg
    S, P = 2304, 2048
    check(S > TF.FULL_ATTN_MAX_SEQ, "long: S does not pass the switch")
    rng = np.random.RandomState(7)
    tokens = torch.tensor(rng.randint(1, cfg.vocab_size, size=(1, S)),
                          device=dev)
    mask = torch.zeros((1, S), device=dev)
    mask[:, P:] = 1.0
    adv = torch.tensor(rng.choice([-1.0, 1.0], size=(1, S)),
                       dtype=torch.float32, device=dev) * mask
    calls = {"full_attention": 0, "blockwise_attention": 0}
    originals = {n: getattr(L, n) for n in calls}

    def counted(name):
        def attend(*a, **k):
            calls[name] += 1
            return originals[name](*a, **k)
        return attend
    for n in calls:
        setattr(L, n, counted(n))
    try:
        with torch.no_grad():
            logits, _ = model.forward(params, {"tokens": tokens})
            old = token_logprobs(logits, tokens) * mask
            del logits
        batch = {"tokens": tokens, "loss_mask": mask, "advantages": adv,
                 "old_logprobs": old}

        def loss_fn(p, b):
            logits, aux = model.forward(p, b)
            return total_loss(logits, aux, b, LossConfig())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        fb_ms = []
        for _ in range(2):      # the first pays the allocator's growth
            grads = None
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
            e.record()
            e.synchronize()
            fb_ms.append(s.elapsed_time(e))
        gnorm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
        grads = None
        trace = profile_call(torch, lambda: value_and_grad(loss_fn, params,
                                                           batch))
    finally:
        for n, fn in originals.items():
            setattr(L, n, fn)
    counts = ops.launch_counts()
    launches["long"] = counts
    check(math.isfinite(float(loss)) and math.isfinite(gnorm) and gnorm > 0,
          f"long: loss {float(loss)}, grad norm {gnorm}")
    check(calls == {"full_attention": 0,
                    "blockwise_attention": 4 * cfg.num_layers},
          f"long: attention calls {calls}")
    check(not any(counts.values()), f"long: launches {counts}")
    emit({"phase": "long", "model": cfg.name, "layers": cfg.num_layers,
          "dtype": "bfloat16", "card": card_name_and_power(),
          "batch": 1, "seq": S, "trained_tokens": S - P,
          "forward_backward_ms": fb_ms, "traced": trace,
          "loss": float(loss), "grad_norm": gnorm,
          "attention_calls": calls,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts})
    del batch
    release(torch)


# ---------------------------------------------------------------------------

# kernel -> (source, TPU kernel it replaces, the serve path it belongs to)
KERNEL_META = {
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "src/repro/kernels/ragged_decode_attention.py:174", "main"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:87", "main"),
    "fused_sample": (
        "src/repro_torch/kernels/csrc/fused_sample.cu",
        "src/repro/kernels/ragged_decode_attention.py:308", "main"),
    "ragged_decode_attention": (
        "src/repro_torch/kernels/csrc/ragged_decode_attention.cu",
        "src/repro/kernels/ragged_decode_attention.py:137", "dense"),
    "paged_decode_attention_int8": (
        "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "src/repro/kernels/ragged_decode_attention.py:120", "int8"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels", "variants", "rl",
                                        "group"), default="all")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global LINES
    OUT.mkdir(exist_ok=True)
    LINES = OUT / f"chip_smoke_{args.phase}.jsonl"
    LINES.write_text("")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    report, launches, keep = {}, {}, {}
    phase_kernels(torch, dev, report)
    if args.phase == "variants":
        phase_variants(torch, dev)
    if args.phase == "all":
        model, params = phase_serve(torch, dev, launches, keep)
        phase_e2e(torch, dev, keep, model, params)
    if args.phase in ("rl", "group"):
        from repro_torch.configs.base import get_config
        from repro_torch.models.model import build_model
        model = build_model(get_config("qwen3_0_6b"))
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if args.phase in ("all", "group"):
        phase_group(torch, dev, model, params, launches)
        phase_serve_tier(torch, dev, model, params, launches)
    if args.phase in ("all", "rl"):
        phase_rl(torch, dev, model, params, launches)
    if args.phase in ("all", "group"):
        phase_long(torch, dev, model, params, launches)
    if args.phase in ("all", "rl", "group"):
        del model, params
        release(torch)
        phase_rl_session(torch, launches, extras_only=args.phase == "group")
    emit({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches.get(path, {}).get(name, 0), path=path,
             launches_per_path={p: c.get(name, 0)
                                for p, c in launches.items()},
             max_abs_err=report[name]["max_abs_err"], tol=report[name]["tol"],
             rtol=report[name].get("rtol", 0.0),
             ms=report[name]["ms"], kernel_ms=report[name]["kernel_ms"],
             kernels_per_call=report[name][
                 "kernels_per_call"],
             plain_ms=report[name]["plain_ms"],
             bound_ms=report[name]["bound_ms"],
             bound_by=report[name]["bound_by"],
             library_ms=report[name]["library_ms"],
             sass_bf16=report[name]["sass_bf16"],
             registers=report[name].get("registers"),
             shape=report[name]["shape"])
        for name, (src, rep, path) in KERNEL_META.items()]})
    print(card_name_and_power(), flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
