#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                   # every phase but variants
    python3 chip_smoke.py --phase kernels   # build + kernel checks only
    python3 chip_smoke.py --phase variants  # + design variants, ablations
    python3 chip_smoke.py --phase rl        # kernel checks + the rl phase
    python3 chip_smoke.py --phase group     # kernel checks + the control
                                            # plane (group, serve_tier,
                                            # long, the option sessions)
    python3 chip_smoke.py --phase families  # kernel checks + the families
                                            # (dense, MoE, VLM, audio,
                                            # hybrid, ssm) + rl_moe +
                                            # rl_vlm + rl_hybrid
    python3 chip_smoke.py --phase moe_ep    # kernel checks + moe_layer +
                                            # moe_ep (the expert-parallel
                                            # MoE on an NCCL world of one)
    python3 chip_smoke.py --phase mesh      # kernel checks + mesh (the
                                            # placed launch steps on an
                                            # NCCL world of one)
    python3 chip_smoke.py --phase launch    # kernel checks + the launch
                                            # path (train, prefill, serve
                                            # steps at full width)

Phases, each printing one JSON line:

1. ``kernels``: build the five CUDA kernels from ``src/repro_torch/
   kernels/csrc`` and hold each against its plain PyTorch version on the
   card, at the serve phase's shapes and at edge shapes, with the
   tolerance stated beside each case (the decode kernels also at the
   edges of their row splits); check that no decode instantiation
   spills registers; time the wrapper (``ms``), the device time of the
   launches one call makes (``kernel_ms``, torch.profiler), the plain
   version and a PyTorch yardstick (``library_ms``, never called by the
   port).  The same at the shapes of Gemma2-2B (D 256, G 2, softcap 50,
   window 4096), Qwen1.5-110B (H 64, an 8192 x 152,064 head) and
   Nemotron-4-340B (D 192, G 12: fp and int8 pages; an 18,432 x 256,000
   head, x streamed through the fused head), Granite-MoE-3B-A800M (D 64,
   G 3: fp pages, int8 pages and dense; a tied head of V 49,155),
   Qwen3-MoE-235B-A22B (D 128, G 16: fp and int8 pages, dense; a 4096 x
   151,936 head), Phi-3-Vision-4.2B (D 96, G 1: flash over 576 patch
   rows and 1024 columns, fp pages, int8 pages (rows padded to 8 chunks
   in shared memory) and dense; a 3072 x 32,064 head) and Whisper-small
   (D 64, G 1: its decoder's
   prefill wave, its 448-row self-attention cache and its
   cross-attention over 1500 live rows) and Zamba2-1.2B (D 64, G 1: the
   dense decode with ``kv_start`` over its left-padded slots, flash with
   the left-pad mask as segment ids over its 1024-wide prefill wave),
   and at their edges (``family_shapes``); the launch path's long rows:
   the dense decode's lse output (``LSE_RULE``) at the serve shape, at
   one ``seqshard`` block of decode_32k (8,320 rows, a slot with none),
   over one 33,280-row slot (every CTA's merge), in f32, and at the
   placed serve steps' blocks (``LSE_PLACED_CASES``: Gemma2's (256, 2)
   under its softcap 50 over a long_500k block and a ring block,
   Nemotron's (192, 12)), timed with and without it; decode_32k's 33,280 rows cut into 4 blocks, each
   through the kernel with its lse and combined, against one call
   (``DECODE_RULE``);
   flash at S = 32,768 (and 32,767), the dense decode over 33,280 rows
   (B 8, D 128, G 2) and over 524,800 (B 1, D 256, G 2, softcap 50: one
   slot over every CTA, merged in the kernel); the dense decode with
   ``kv_start`` at 0, one live row, a split's edge and inside a split,
   ``kv_start = kv_len`` and ``kv_len`` 0, in bf16 and f32, and its bf16
   plan's edges on this card's grid; the int8
   pages at (192, 12), (128, 16) and (96, 1) at kv_len 0 and 1, a page's
   last and first row as the slot's new row, both sides of a split and a
   zero page (scale at its 1e-8 floor); bf16 flash at S 1, 63, 64, 65,
   127, 128, 129, 255, 256 and 257 at every bf16 D (64, 96, 128, 192,
   256) through every mix of segments, window and softcap, G 1, 4, 12,
   16 (the edges of its 128-row query and 64-key tiles), and a
   q base off the 16-byte grid its TMA copies need (the wrapper must
   raise, the C entry refuse, nothing launch).  The bf16 flash and fused
   head instantiations must hold ``HGMMA`` instructions (and no ``HMMA``)
   and spill nothing; a bf16 fused head call is one launch (no merge
   pass), W read once (one pass) at every head, B 1 to 64, and each case
   repeats bit for bit.  The bf16 paged and dense decode instantiations
   must hold ``HMMA`` and spill nothing; each bf16 decode case repeats
   bit for bit, and a timed bf16 decode call (cold L2) is one launch.
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
7. ``moe_layer``: the MoE layer (the reference's capacity-drop
   ``moe_mlp_dense``) at Granite-MoE's width and published capacity
   factor on the card against the CPU, f32: routing and drops equal.
   ``moe_ep``: an NCCL world of one (a ``FileStore`` in a temporary
   directory, no network) and the (1, 1) ``("data", "model")``
   ``DeviceMesh`` on the card; the reference's expert-parallel layer
   (``moe_mlp_ep``: ``all_to_all_single`` over the model axis, under the
   placement a placed step installs) at that width against
   ``moe_mlp_dense`` (idx and keep equal, y within 1e-4 of the largest
   |y|, aux within 1e-6, each call timed); the group destroyed at the
   end.  Granite's placed train and prefill steps over it are ``mesh``'s.
   ``mesh``: the dense family's placed launch steps on an NCCL world of
   one and the (1, 1) ``DeviceMesh``: Qwen3-0.6B at full width, bf16, 4
   layers, its train_4k (B 2, S 4096, 2 steps), prefill_32k (B 1) and
   decode_32k (B 8, 4 steps) plans, Gemma2-2B's decode_32k (B 8) and
   long_500k (B 1) serve steps over its ring and global caches, and the
   ``decode_2d`` serve steps of Qwen1.5-110B (4 layers) and
   Nemotron-4-340B (2 layers, B 8), each against the same step on
   ``make_local_mesh()`` bit for bit (tokens, log-probs, caches, loss,
   grad norm, every leaf), flash and dense decode launches counted.
   ``families``: Gemma2-2B at full width and depth (26 local/global
   layers, rings of 4096, the dense layout, 16 requests of 512-6144 ids
   in one 8192-wide wave), Qwen1.5-110B at full width cut to 4 layers and
   Nemotron-4-340B at full width cut to 2 (paged, fused greedy head, 32
   and 16 requests of 64-1024 ids), random weights, one after another:
   exactly each path's kernels, 3 requests each held to the plain
   forward (0.1 nats, tokens equal but at near-ties), step times,
   tokens/s and peak memory; Nemotron again on int8 KV pages
   (``nemotron_int8``: exactly the int8 decode's launches, none of the fp
   one's; the pool and scales in GB; a second run with the int8 decode
   through the plain version on the card and the kernel held within 2e-2
   of it at every call, the two runs' streams reported,
   ``int8_plain_witness``; its gap to the forward
   reported against ``NEAR_TIE_INT8``, 0.1 nats plus the int8 allowance,
   stated before the first run; the zeroed part seen; and the same int8
   engine at 1 layer of the published heads and width on the card
   against CPU tensors within 0.05 nats, ``int8_card_against_cpu``).
   Then Granite-MoE-3B-A800M at full width
   and depth and Qwen3-MoE-235B-A22B at full width cut to 4 layers
   (paged, fused head, 32 requests): served and timed at the published
   capacity factor (dropped shares counted), then at capacity factor
   E / k (no drops) with 3 requests held to the plain forward
   (``held_to_f32``); Qwen3-MoE again on int8 pages (``qwen3_moe_int8``:
   both runs witnessed by ``int8_plain_witness``;
   reported against ``held_to_f32`` with the int8 allowance, the zeroed
   part seen, and card against CPU at 1 layer).  Then
   Phi-3-Vision-4.2B at full width and depth
   (32 layers, 576 zero patch rows before every prompt; paged with the
   fused head, 32 requests, then the dense layout, 16, then paged on
   int8 pages, 32, as Nemotron's int8 run) and Whisper-small
   at full width and depth (12 + 12 layers, 1500 zero frames; the dense
   layout and the plain head, 32 requests of 16-224 ids in 448 rows),
   held to the plain forward as the dense family is (for Whisper the
   zeroed-layer check runs on its self- and its cross-attention);
   ``prefill_patches``: Phi-3-Vision's prefill on random patch rows
   against the forward; Whisper's prefill wave timed in parts (the plain
   encoder and cross-attention).  Then the left-padded recurrent
   families on the dense layout with the plain head, 32 requests of
   64-1024 ids in one wave: Zamba2-1.2B at full width and depth (38
   Mamba2 layers, the shared attention block 6 times: exactly 6 flash
   launches a wave and 6 dense decodes a step) and xLSTM-125M (12
   blocks: no kernel launch), xLSTM held to the plain forward, Zamba2
   (whose bf16 forward sits ~0.3 nats from its f32 forward at random
   weights) to the f32 forward as ``held_to_f32`` holds the MoE runs
   (the shared block's or the last sLSTM projection zeroed must fail the
   check) and,
   with the biases the reference's left-padded prefill leaks through
   perturbed, 4 requests in one padded wave held to the forward on the
   same weights (``pad_exact``).  ``rl_moe``: SortedRL's loop on
   Granite-MoE at full width and depth (the ``rl`` phase's loop, update
   batches of 8, bf16 AdamW moments): every uid trained once, the router
   and the experts moved, the engine-against-trainer gap reported.
   ``rl_vlm``: the same loop on Phi-3-Vision-4.2B (``max_total_len``
   1024 for the patch rows): the gap between the engine (behind patch
   rows) and the trainer (without them, as in the reference) reported.
   ``rl_hybrid``: the same loop on Zamba2-1.2B on the dense layout, 4
   updates, the engine's logprobs held to the f32 forward as the
   trainer's bf16 forward is (``phase_rl``'s ``gap_to_f32``).

8. ``launch``: the launch path (``repro_torch/launch``) at published
   widths, bf16, random weights from a seed.  ``launch_train``: 2 steps
   of ``build_train_step`` under each model's train_4k plan (its remat,
   microbatches and moment dtype) for Qwen3-0.6B, Gemma2-2B,
   Granite-MoE-3B-A800M, Phi-3-Vision-4.2B (576 zero patch rows),
   Whisper-small (1500 zero frames), Zamba2-1.2B (S 4096) and
   xLSTM-125M (S 1024), Qwen3 and Whisper at full depth, the others cut
   to ``LAUNCH_DEPTH`` layers, the batch cut to 2-4 (``LAUNCH_CUTS``):
   update ms (the second step's), peak GB, loss and grad norm (finite),
   the fit report's ``model_flops`` and persistent bytes (peak at least
   those), their share of 989 TFLOP/s, no kernel launch; where the plan
   has microbatches, the step at 2 layers in f32 held to the same step at
   ``microbatches=1`` (an MoE: to its definition) within ``STEP_TOL``.
   ``launch_prefill``: ``build_prefill_step`` on Qwen3-0.6B at S = 32,768,
   B 1: exactly 28 flash launches, then a run with flash's plain version
   at every call and the kernel held to it (``PlainWitness``), tokens
   equal but at a tie inside both.  ``launch_serve``: 8 steps of
   ``build_serve_step`` on Qwen3-0.6B at decode_32k (B 8, 33,280 rows)
   and Gemma2-2B at long_500k (B 1, 524,800 global rows) over random
   caches: exactly the dense decode's launches, then 8 witnessed steps
   (every call within ``DECODE_RULE``), step ms and tokens/s.

``--phase variants`` adds, after the kernel checks, one more line: the
bf16 flash, fused-head, paged decode (fp and int8 pages) and dense
decode kernels
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
import functools
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


def device_ms(torch, fn, n: int = 20, cold: bool = False):
    """Device time of the kernels one call of ``fn`` launches, summed
    (torch.profiler's CUDA kernel durations over ``n`` calls, divided by
    n), and per kernel its launches and device ms per call: the kernel
    without the host time of its wrapper, which ``cuda_ms`` times back to
    back.  A profile that kept only some launches of a kernel is taken
    again (up to three times), then read as the median of its single
    launches times its launches a call.  ``cold``: each call after an L2
    flush (``flush_l2``), whose
    launches are left out: at most the flushes' own count of each of
    their kernels (a profile may drop events), so that a call launching
    such a kernel itself fails the run rather than hide in the flush;
    then each kernel's time is the median of its single launches (times
    its launches a call), which a profile that drops some device events,
    or one slow call, does not move."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    skip = flush_l2(torch) if cold else {}
    n = max(n, 30) if cold else n
    # a profile now and then comes back without its device events (one
    # of 32 in one run, a kernel that the next profile saw), or with some
    # of them; up to three profiles, the last one with device time kept,
    # and no device time in all three fails the run
    kept = (0.0, {})
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if cold:
                    flush_l2(torch)
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages()
                if r.device_type == torch.autograd.DeviceType.CUDA]
        for r in rows:
            if r.key in skip:
                check(r.count <= n * skip[r.key],
                      f"{r.key[:60]}: {r.count} launches in {n} calls, of "
                      f"which the L2 flushes made {n * skip[r.key]}")
        rows = [r for r in rows if r.key not in skip]
        per = {r.key: {"launches": r.count / n,
                       "ms": r.self_device_time_total / 1e3 / n}
               for r in rows}
        # a profile that kept only some of a kernel's launches (seen as a
        # fraction of a launch a call: half of them in one run) is taken
        # again; the last one left so is read per launch
        whole = all(v["launches"] >= 1
                    and abs(v["launches"] - round(v["launches"])) < 1e-9
                    for v in per.values())
        if cold or not whole:
            single = {}
            for e in prof.events():
                if (e.device_type == torch.autograd.DeviceType.CUDA
                        and e.key in per):
                    single.setdefault(e.key, []).append(
                        e.self_device_time_total / 1e3)
            for k, v in per.items():
                if single.get(k):
                    v["ms"] = statistics.median(single[k]) \
                        * max(1, round(v["launches"]))
        ms = sum(v["ms"] for v in per.values())
        if ms > 0:
            kept = (ms, per)
            if whole:
                break
    ms, per = kept
    check(ms > 0, f"profiler saw no device time for {fn}")
    return ms, {k[:60]: v for k, v in per.items()}


# a hot call through its C entry spends at most this share of its
# back-to-back CUDA-event time off the device (0.945-0.99 read on an H100
# at the fused heads and flash's serve shape)
HELD_SHARE = 0.85


def held_device_ms(torch, fn, floor, what, tries=3):
    """``device_ms`` of a hot call, taken again while it reads below
    ``floor``: the call's bound, and for a call through its C entry also
    ``HELD_SHARE`` of its own CUDA-event time.  A profile late in a long
    process now and then reads a kernel at about half its time with whole
    launch counts, which a median of three rounds does not absorb when two
    read low; every one of ``tries`` profiles reading low fails the run."""
    for _ in range(tries):
        ms = device_ms(torch, fn)[0]
        if ms >= floor:
            break
    check(ms >= floor, f"{what}: device time {ms:.4f} ms below "
          f"{floor:.4f} in {tries} profiles")
    return ms


_FLUSH = []


def flush_l2(torch):
    """Write 160 MB (over three times the H100's 50 MB L2), so that the
    next call finds its inputs in device memory, as an engine's layer does
    (each of its layers reads its own pool).  Returns {kernel name:
    launches a flush}, which cold timings leave out.  (Summing the buffer
    instead leaves clean lines, but evicted a pool that fits L2 less
    surely, and its kernel's time was not reliably left out.)"""
    if not _FLUSH:
        buf = torch.empty(40 * 2**20, device="cuda")
        from torch.profiler import ProfilerActivity, profile
        buf.fill_(1.0)
        torch.cuda.synchronize()
        # a profile may come back without its device events: then the
        # flush's kernel would count as the timed call's
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                buf.fill_(1.0)
                torch.cuda.synchronize()
            names = {r.key: r.count for r in prof.key_averages()
                     if r.device_type == torch.autograd.DeviceType.CUDA}
            if names:
                break
        check(bool(names), "flush_l2: no profile saw the flush's kernel")
        _FLUSH.append((buf, names))
    buf, names = _FLUSH[0]
    buf.fill_(1.0)
    return names


def cuda_ms_cold(torch, fn, reps: int = 15) -> float:
    """Median over ``reps`` calls of one call's time between CUDA events,
    each call after an L2 flush (outside the events)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush_l2(torch)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def timings(torch, fn, plain, library, ms_reps=(7, 10), plain_reps=(5, 3),
            cold=False):
    """ms (wrapper, CUDA events), kernel_ms (device time of the call's
    launches), plain_ms and library_ms (None where no PyTorch call
    computes the same function), measured in this run.  ``cold``: ms,
    kernel_ms and library_ms each call after an L2 flush (``flush_l2``;
    the decode rows: an engine's layer reads its pool from device
    memory), plain_ms back to back."""
    if cold:
        ms = cuda_ms_cold(torch, fn)
        kernel_ms, per_call = device_ms(torch, fn, cold=True)
        return dict(ms=ms, kernel_ms=kernel_ms, kernels_per_call=per_call,
                    plain_ms=cuda_ms(torch, plain, *plain_reps),
                    library_ms=(cuda_ms_cold(torch, library, reps=5)
                                if library is not None else None),
                    l2="cold")
    ms = cuda_ms(torch, fn, *ms_reps)          # before the profiler runs
    kernel_ms, per_call = device_ms(torch, fn)
    return dict(ms=ms, kernel_ms=kernel_ms,
                kernels_per_call=per_call,
                plain_ms=cuda_ms(torch, plain, *plain_reps),
                library_ms=(cuda_ms(torch, library, reps=5, inner=3)
                            if library is not None else None))


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


def paged_nb(kv_lens, P=16):
    """The block table's width ``paged_inputs`` gives these lengths."""
    need = [max(1, -(-int(n) // P)) for n in kv_lens]
    return 1 << (max(need) - 1).bit_length()


def placed_new_row(plan_of, lens, Kh, group, edge):
    """kv_len of the slots (``lens`` with slot 0's length moved) whose bf16
    paged plan puts slot 0's new row (row len - 1) on the first row of a
    CTA's share (its last page opens the share and holds only that row),
    or (``last``) a slot's last page, with its new row, on a share's last
    unit; None when no length up to 2048 rows does."""
    for n0 in range(17, 2049, 16):
        cand = [n0] + list(lens[1:])
        shares, pieces = plan_of(cand)
        nb = paged_nb(cand)
        pages = [-(-min(int(n), 16 * nb) // 16) for n in cand]
        for pc in pieces:
            if pc.whole:
                continue
            item0 = (Kh // group) * sum(pages[:pc.b]) \
                + pc.kh // group * pages[pc.b]
            if edge == "first" and pc.b == 0 and pc.lo == pages[0] - 1 \
                    and shares[pc.cta][0] == item0 + pc.lo:
                return cand
            if edge == "last" and pc.hi == pages[pc.b] \
                    and shares[pc.cta][1] == item0 + pc.hi:
                return cand
    return None


def repeat_equal(torch, what, first, call):
    """A second call on the same inputs equals the first bit for bit (the
    bf16 decode kernels merge split slots through counters they set back
    to 0)."""
    again = call()
    torch.cuda.synchronize()
    check(bool(torch.equal(first, again)),
          f"{what}: a second call differs from the first")


def one_kernel(name, report):
    """The paged path's serve call launches exactly one kernel, the bf16
    Hopper kernel, and no merge pass."""
    one_launch(report[name]["kernels_per_call"], "paged_decode_hopper_kernel",
               name)


def one_launch(per_call, kernel, name):
    """A call's profile (``device_ms``'s kernels per call) holds one
    launch of ``kernel`` and nothing else: no merge pass."""
    check(len(per_call) == 1 and all(kernel in k for k in per_call)
          and all(abs(v["launches"] - 1.0) < 1e-9 for v in per_call.values()),
          f"{name}: a call must launch the one bf16 kernel, got {per_call}")


def fused_case(torch, ops, ref, record, maxerr, name, x, w, k, cap):
    """One fused head case against the plain version (values, lse and
    the logit each index claims within 1e-3; ``idx_equal``), called twice
    (``repeat_equal``: bit for bit; checked), with the bf16 kernel's plan
    at these shapes."""
    from repro_torch.kernels import fused_sample as fsm
    vals, idx, lse = ops.fused_sample(x, w, top_k=k, softcap=cap)
    again = ops.fused_sample(x, w, top_k=k, softcap=cap)
    rv, ri, rl = ref.fused_sample_ref(x, w, top_k=k, softcap=cap)
    logits = x.float() @ w.float()
    if cap > 0:
        logits = torch.tanh(logits / cap) * cap
    claimed = torch.gather(logits, 1, idx.long())
    torch.cuda.synchronize()
    err = max(maxerr(vals, rv), maxerr(lse, rl), maxerr(claimed, vals))
    same = all(torch.equal(a, b) for a, b in zip((vals, idx, lse), again))
    check(same, f"fused_sample/{name}: a repeated call differs")
    plan = (fsm.plan(x.shape[0], x.shape[1], w.shape[1], k,
                     fsm.sm_count(x.device)).__dict__
            if x.dtype == torch.bfloat16 else None)
    return record("fused_sample", name, err, 1e-3,
                  {"idx_equal": bool((idx == ri).all()),
                   "repeat_equal": same, "plan": plan}), (vals, idx)


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


# bf16 decode (paged fp pages and the dense cache), per element:
#   |out - want| <= 2^-7*|want| + 2^-5*rms(want[b]),
# rms over slot b's heads and dims.  The plain version rounds q/sqrt(D)
# and the softmax weights to bf16 before its f32 products, as the
# reference's jnp decode does; the kernel keeps them in f32, as the
# Pallas body does; both round the output to bf16.  One output step is
# at most 2^-7*|want|; the weights' rounding moves an output by a sum of
# terms of ~2^-9 of the slot's typical output, rms(want[b]).  The
# kernels' split arithmetic in f32 stays within 0.01*rms of the step,
# one split weighted 5% high goes past 2^-5*rms
# (tests/test_torch_kernels.py).  No fixed limit fits both ends: one
# row gives |out| ~ 1, thousands give rms ~ 0.03.
DECODE_RTOL, DECODE_RMS = 2.0 ** -7, 2.0 ** -5
DECODE_RULE = "2^-7*|want| + 2^-5*rms(want[slot])"


def decode_excess(out, want):
    """Over the slots with rows (a kv_len 0 slot's zeros are checked
    exactly by the cases that hold one): the max of |out - want| -
    2^-7*|want| - 2^-5*rms(want[b]) (a case passes at <= 0), the max of
    (|out - want| - 2^-7*|want|) / rms(want[b]) (against 2^-5), and the
    least slot rms."""
    o, w = out.float(), want.float()
    rms = w.pow(2).mean(dim=tuple(range(1, w.dim()))).sqrt()
    live = rms > 0
    if not bool(live.any()):
        return 0.0, 0.0, 0.0
    o, w, rms = o[live], w[live], rms[live]
    rms_b = rms.view(-1, *[1] * (w.dim() - 1))
    beyond = (o - w).abs() - DECODE_RTOL * w.abs()
    return (float((beyond - DECODE_RMS * rms_b).max()),
            float((beyond / rms_b).max()), float(rms.min()))


LSE_RULE = ("|lse - want| <= u * max over live rows of sum_d |q_d| |k_d| "
            "/ sqrt(D) + 1e-4, u = 2^-8 in bf16 (the plain version rounds "
            "q / sqrt(D) to bf16; the kernel scales the f32 product), 0 in "
            "f32; under a softcap |lse - want| <= LSE_CAP_TOL; -inf "
            "exactly where the plain version has it; the output within "
            "DECODE_RULE of the plain version's")
# one seqshard block of decode_32k's 33,280 cache rows on 4 ranks, Qwen3's
# heads (H 16, Kh 8, D 128): slot 3 has no live row in the block
LSE_BLOCK_LENS = [8320, 8320, 5000, 0, 1, 17, 8320, 4000]
# the placed serve steps' blocks, (name, dtype, kv_len, rows, H, Kh, D,
# softcap): Gemma2's heads under its attention softcap 50 (q scaled by
# LSE_CAP_QSCALE so that the scores reach the cap: the lse must be the
# capped scores'), one long_500k block of 524,800 rows on 4 ranks and one
# 1,024-row block of its 4,096-row ring on (1, 4) (slots 1 and 5 with no
# live row there); Nemotron's (192, 12) at a decode_2d block of 8,320
LSE_PLACED_CASES = (
    ("gemma2_long_block_b1_s131200_bf16_cap50", "bfloat16", [131_200],
     131_200, 8, 4, 256, 50.0),
    ("gemma2_ring_block_b8_s1024_bf16_cap50", "bfloat16",
     [1024, 0, 5, 1024, 300, 0, 1024, 17], 1024, 8, 4, 256, 50.0),
    ("nemotron_block_b8_s8320_bf16", "bfloat16", LSE_BLOCK_LENS, 8320, 96,
     8, 192, 0.0),
    # the MoE serve steps on (2, 2): Granite-MoE's seqshard block (8 of 16
    # slots, 16,640 of 33,280 rows; the 24 query heads gathered over
    # model for the kernel, the 8 KV heads whole: G 3 at D 64) and
    # Qwen3-MoE's decode_2d block (4 of 8 slots; 64 heads over 4 KV
    # heads: G 16 at D 128)
    ("granite_moe_block_b8_s16640_bf16", "bfloat16",
     [16_640, 16_640, 9000, 0, 1, 17, 16_640, 5000], 16_640, 24, 8, 64, 0.0),
    ("qwen3_moe_block_b4_s16640_bf16", "bfloat16", [16_640, 0, 3, 12_000],
     16_640, 64, 4, 128, 0.0))
LSE_CAP_QSCALE = 40.0
# the capped cases' lse limit: the top scores sit near the cap, where
# tanh' is near 0 and q's bf16 rounding barely moves them (an H100 gave
# 1.1e-5); the uncapped bound, u * max sum_d |q_d| |k_d| / sqrt(D), is
# about 1.7 nats there and would let scores capped from a wrong scale pass
LSE_CAP_TOL = 1e-3
COMBINE_ROWS, COMBINE_BLOCKS = 33_280, 4
COMBINE_LENS = [33_272, 33_272, 20_000, 8_000, 1, 33_280, 12_345, 9_000]


def lse_excess(torch, lse, want, q, k, kv_len, bf16, softcap=0.0):
    """Max of |lse - want| less ``LSE_RULE``'s bound over the heads with
    live rows (<= 0 passes; ``LSE_CAP_TOL`` under a softcap), and whether
    -inf sits exactly where ``want`` has it."""
    inf_equal = bool(torch.equal(torch.isneginf(lse), torch.isneginf(want)))
    fin = torch.isfinite(want)
    if softcap:
        excess = float((lse - want).abs()[fin].max()) - LSE_CAP_TOL \
            if fin.any() else 0.0
        return excess, inf_equal
    B, H, D = q.shape
    S, Kh = k.shape[1], k.shape[2]
    qa = q.float().abs().reshape(B, Kh, H // Kh, D) / D ** 0.5
    live = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
    bound = torch.zeros((B, H), device=q.device)
    for b in range(B):            # one slot at a time: (Kh, G, S) floats
        if live[b].any():
            s = torch.einsum("kgd,skd->kgs", qa[b], k[b].float().abs())
            bound[b] = s[..., live[b]].amax(dim=-1).reshape(H)
    tol = (2.0 ** -8 if bf16 else 0.0) * bound + 1e-4
    excess = float(((lse - want).abs() - tol)[fin].max()) if fin.any() \
        else 0.0
    return excess, inf_equal


def dense_lse_checks(torch, dev, serve_args, report):
    """The dense decode's lse output against its plain version
    (``LSE_RULE``) at the serve shape (its items whole and merged by the
    completing CTA), at one ``seqshard`` block of decode_32k (8,320 rows,
    slot 3 with none: lse -inf, output zeros), over one slot of 33,280
    rows (B 1: its item over every CTA, merged by each; the plan twin
    says more than ``kDdSpreadPieces`` pieces) and in f32 (the split body
    and its merge pass); the output with the lse equals the one without it
    bit for bit; the serve shape timed with and without it (cold L2)."""
    from collections import Counter

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ragged_decode_attention as rdm
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("serve_b32_s2048_bf16", serve_args, {})]
    for name, dt, lens, S, H, Kh, D, cap in (
            ("seqshard_block_b8_s8320_bf16", bf16, LSE_BLOCK_LENS, 8320, 16,
             8, 128, 0.0),
            ("one_slot_b1_s33280_bf16", bf16, [33_280], 33_280, 16, 8, 128,
             0.0),
            ("split_merge_b4_s4096_f32", f32, [4096, 0, 1, 3000], 4096, 16,
             8, 128, 0.0)) + LSE_PLACED_CASES:
        dt = getattr(torch, dt) if isinstance(dt, str) else dt
        args = dense_inputs(torch, dev, dt, lens, S, H, Kh, D)
        if cap:                     # scores of a few caps' size: tanh bites
            args = (args[0] * LSE_CAP_QSCALE,) + args[1:]
        cases.append((name, args, {"softcap": cap} if cap else {}))
    pieces = ref.ragged_decode_work_plan(
        [33_280], None, 33_280, 8, rdm.hopper_ctas(128, 2),
        rdm.hopper_rows(128, 2), rdm.hopper_group(128, 2, 8))[1]
    spread = max(Counter(pc.kh for pc in pieces).values())
    check(spread >= 33, f"dense lse: the one-slot case's item has {spread} "
          "pieces, not the every-CTA merge's 33 or more")
    rows = []
    for name, args, kw in cases:
        q, k, v, kv = args
        out, lse = ops.ragged_decode_attention(*args, return_lse=True, **kw)
        plain = ops.ragged_decode_attention(*args, **kw)
        want_o, want = ref.ragged_decode_attention_ref(*args, return_lse=True,
                                                       **kw)
        torch.cuda.synchronize()
        excess, inf_equal = lse_excess(torch, lse, want, q, k, kv,
                                       q.dtype == bf16, kw.get("softcap", 0))
        row = {"case": name, "lse_excess": excess, "inf_equal": inf_equal,
               "out_equal_without_lse": bool(torch.equal(out, plain)),
               "out_excess": decode_excess(out, want_o)[0],
               "lse_max_abs_err": float((lse - want)[torch.isfinite(want)]
                                        .abs().max())}
        check(excess <= 0 and inf_equal and row["out_equal_without_lse"]
              and row["out_excess"] <= 0, f"dense lse/{name}: {row}")
        empty = (kv == 0).nonzero()[:, 0]
        if len(empty):
            check(bool((out[empty] == 0).all())
                  and bool(torch.isneginf(lse[empty]).all()),
                  f"dense lse/{name}: a slot with no live row")
        rows.append(row)
        del q, k, v, out, plain, want_o, lse, want
    del cases, args
    release(torch)
    ms = cuda_ms_cold(torch, lambda: ops.ragged_decode_attention(
        *serve_args))
    ms_lse = cuda_ms_cold(torch, lambda: ops.ragged_decode_attention(
        *serve_args, return_lse=True))
    report["ragged_decode_attention"].update(
        lse_rule=LSE_RULE, lse_cases=rows, ms_serve_cold=ms,
        ms_serve_cold_with_lse=ms_lse)
    emit({"phase": "kernels_dense_lse", "card": card_name_and_power(),
          "rule": LSE_RULE, "cases": rows, "every_cta_merge_pieces": spread,
          "serve_ms_cold": ms, "serve_ms_cold_with_lse": ms_lse})


def dense_combine_check(torch, dev):
    """decode_32k's 33,280 cache rows (B 8, Qwen3's heads) cut into 4
    blocks of 8,320, the kernel called on each with its local lengths
    (``clamp(kv_len - offset, 0, 8320)``) and its lse, the blocks combined
    (``sharding.combine_decode``, f32 weights), against one call over every
    row and against the plain version, by ``DECODE_RULE``; slot 4 (one
    row) has rows in block 0 only."""
    from repro_torch.kernels import ops, ref
    from repro_torch.distributed.sharding import combine_decode
    args = dense_inputs(torch, dev, torch.bfloat16, COMBINE_LENS,
                        COMBINE_ROWS, 16, 8, 128)
    q, k, v, kv = args
    whole = ops.ragged_decode_attention(*args)
    R = COMBINE_ROWS // COMBINE_BLOCKS
    parts = []
    for r in range(COMBINE_BLOCKS):
        kb, vb = (t[:, r * R:(r + 1) * R].contiguous() for t in (k, v))
        local = (kv - r * R).clamp(0, R).to(torch.int32)
        parts.append(ops.ragged_decode_attention(q, kb, vb, local,
                                                 return_lse=True))
        del kb, vb
    combined, _ = combine_decode(parts)
    want = ref.ragged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    row = {"phase": "kernels_dense_combine", "card": card_name_and_power(),
           "rows": COMBINE_ROWS, "blocks": COMBINE_BLOCKS,
           "kv_len": COMBINE_LENS, "rule": DECODE_RULE,
           "excess_vs_one_call": decode_excess(combined, whole)[0],
           "excess_vs_plain": decode_excess(combined, want)[0],
           "one_call_excess_vs_plain": decode_excess(whole, want)[0],
           "max_abs_diff_vs_one_call": float((combined.float()
                                              - whole.float()).abs().max())}
    check(row["excess_vs_one_call"] <= 0 and row["excess_vs_plain"] <= 0,
          f"dense combine: {row}")
    emit(row)
    del args, q, k, v, whole, parts, want
    release(torch)


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
    if not window and seg is None:
        return S * (S + 1) // 2
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


# query lengths around the bf16 flash kernel's 128-row query tiles and
# 64-key tiles
FLASH_EDGE_S = (1, 63, 64, 65, 127, 128, 129, 255, 256, 257)

# kernel -> (library, regex of its bf16 instantiation's function names)
BF16_FUNCTIONS = {
    "flash_attention": ("flash_attention", r"flash_wgmma_kernel"),
    "fused_sample": ("fused_sample", r"sample_wgmma_kernel"),
    "paged_decode_attention": ("paged_decode_attention",
                               r"paged_decode_hopper_kernelI13__nv_bfloat16"),
    "paged_decode_attention_int8": ("paged_decode_attention",
                                    r"paged_decode_hopper_kernelIa"),
    "ragged_decode_attention": ("ragged_decode_attention",
                                r"dense_decode_hopper_kernel"),
}
# bf16 decode instantiations (paged_decode_hopper.cuh,
# dense_decode_hopper.cuh): fp pages and the dense cache at D 64/128 x G
# 1/2/4/8, (64, 3), (192, 12), (256, 2), (128, 16), (96, 1); int8 pages at
# the same but (256, 2).  Each must issue tensor-core instructions
# (mma.sync: HMMA) and spill nothing.
PAGED_BF16_INSTANTIATIONS = {"paged_decode_attention": 13,
                             "paged_decode_attention_int8": 12,
                             "ragged_decode_attention": 13}
TENSOR_CORE_OPS = re.compile(r"\bHG?MMA\.")   # mma.sync -> HMMA, wgmma -> HGMMA
WGMMA_OPS = re.compile(r"\bHGMMA\.")
# bf16 flash instantiations (D 64, 96, 128, 192, 256): each must issue
# wgmma (HGMMA) and no mma.sync (HMMA)
FLASH_BF16_DS = (64, 96, 128, 192, 256)
# bf16 fused head instantiations (N 8, 16, ..., 64 x tied or untied): each
# must issue wgmma (HGMMA) and no mma.sync (HMMA)
FUSED_BF16_FUNCTIONS = 16
# decode kernel -> (library, regex of every instantiation: the split-KV
# body's (f32 q at D 64/128 x G 1/2/4/8 and (64, 3), f32 D 32 G 1 on fp
# pages) and its merge pass, and the bf16 Hopper kernels)
DECODE_FUNCTIONS = {
    "paged_decode_attention": ("paged_decode_attention",
                               r"decode_split_kernelIff"
                               r"|paged_decode_hopper_kernelI13__nv_bfloat16"
                               r"|decode_merge_kernel"),
    "paged_decode_attention_int8": ("paged_decode_attention",
                                    r"decode_split_kernelIfa"
                                    r"|paged_decode_hopper_kernelIa"
                                    r"|decode_merge_kernel"),
    "ragged_decode_attention": ("ragged_decode_attention",
                                r"decode_(split|merge)_kernel"
                                r"|dense_decode_hopper_kernel"),
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


# split-pass instantiations per decode kernel, f32 q only: D 64/128 x G
# 1/2/4/8, and (64, 3); on fp pages also D 32, G 1, the RL session's LM
DECODE_SPLIT_INSTANTIATIONS = {"paged_decode_attention": 10,
                               "paged_decode_attention_int8": 9,
                               "ragged_decode_attention": 9}
HOPPER_DECODE = r"(paged|dense)_decode_hopper_kernel"


def decode_registers(build):
    """Registers and spills of every decode instantiation; checked: the
    split-pass instantiations of ``DECODE_SPLIT_INSTANTIATIONS`` and the
    bf16 ones of ``PAGED_BF16_INSTANTIATIONS``, none spills."""
    out = {}
    for name, (lib, pat) in DECODE_FUNCTIONS.items():
        fns = ptxas_functions(build.ptxas_report(lib), pat)
        n_split = sum("decode_split_kernel" in fn for fn in fns)
        n_hopper = sum(bool(re.search(HOPPER_DECODE, fn)) for fn in fns)
        spill = sum(v["spill_bytes"] or 0 for v in fns.values())
        check(n_split == DECODE_SPLIT_INSTANTIATIONS[name]
              and n_hopper == PAGED_BF16_INSTANTIATIONS.get(name, 0)
              and all(v["spill_bytes"] is not None for v in fns.values()),
              f"{name}: {n_split} split and {n_hopper} bf16 Hopper "
              f"instantiations in the ptxas log")
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
    sass, wgmma, out = {}, {}, {}
    for lib in sorted({lib for lib, _ in BF16_FUNCTIONS.values()}):
        txt = subprocess.run([str(tool), "-sass", str(build.lib_path(lib))],
                             capture_output=True, text=True,
                             timeout=120).stdout
        blocks = {blk.split(None, 1)[0]: blk
                  for blk in txt.split("Function : ")[1:] if blk.strip()}
        sass[lib] = {fn: len(TENSOR_CORE_OPS.findall(blk))
                     for fn, blk in blocks.items()}
        wgmma[lib] = {fn: len(WGMMA_OPS.findall(blk))
                      for fn, blk in blocks.items()}
    for name, (lib, pat) in BF16_FUNCTIONS.items():
        regs = ptxas_functions(build.ptxas_report(lib), pat)
        fns = {fn: n for fn, n in sass[lib].items() if re.search(pat, fn)}
        hg = [wgmma[lib][fn] for fn in fns]
        out[name] = {"functions": len(fns),
                     "tensor_core_ops": sum(fns.values()),
                     "min_per_function": min(fns.values()) if fns else 0,
                     "hgmma": sum(hg),
                     "hgmma_min_per_function": min(hg) if hg else 0,
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
    for name, n in PAGED_BF16_INSTANTIATIONS.items():
        got = sass[name]
        check(got["functions"] == n and got["min_per_function"] > 0
              and got["spill_bytes"] == 0,
              f"{name}: each of the {n} bf16 instantiations must issue "
              f"tensor-core instructions and spill nothing {got}")
    for name, n in (("flash_attention", len(FLASH_BF16_DS)),
                    ("fused_sample", FUSED_BF16_FUNCTIONS)):
        got = sass[name]
        check(got["functions"] == n and got["hgmma_min_per_function"] > 0
              and got["hgmma"] == got["tensor_core_ops"],
              f"{name}: each of the {n} bf16 instantiations must issue "
              f"wgmma (HGMMA) and no mma.sync (HMMA) {got}")
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
        or, where ``excess`` is given, if it is at most ``tol``: the max
        of |out - want| less rtol*|want| (and less the rest of
        ``extra["tol_rule"]`` where one is named)."""
        ok = bool((err if excess is None else excess) <= tol)
        rule = (extra or {}).get("tol_rule")
        check(ok, f"{kernel}/{case}: max_abs_err {err:.3g}"
              + (f", {excess:.3g} beyond {rule}" if rule else
                 f" > tol {tol}" + (f" + {rtol:.3g}*|want|" if rtol else "")))
        row = {"kernel": kernel, "case": case, "max_abs_err": err,
               "tol": tol, "rtol": rtol, "excess": excess, "ok": ok}
        row.update(extra or {})
        cases.append(row)
        return row

    def maxerr(a, b):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0

    def decode_record(kernel, case, out, want, f32_case):
        """f32: 1e-4 (only the order of f32 sums differs); bf16: the
        decode rule above."""
        if f32_case:
            return record(kernel, case, maxerr(out, want), 1e-4)
        excess, share, rms = decode_excess(out, want)
        return record(kernel, case, maxerr(out, want), 0.0,
                      {"tol_rule": DECODE_RULE, "beyond_step_over_rms": share,
                       "min_slot_rms": rms},
                      excess=excess, rtol=DECODE_RTOL)

    def max_excess(out, want, rtol):
        o, w = out.float(), want.float()
        return float(((o - w).abs() - rtol * w.abs()).max()) \
            if o.numel() else 0.0

    # -- paged_decode_attention ----------------------------------------------
    # tolerance: f32 1e-4 (only the order of f32 sums differs); bf16 the
    # decode rule (DECODE_RULE, above ``decode_excess``).
    import numpy as np
    from collections import Counter
    from repro_torch.kernels import paged_decode_attention as pdm
    serve_lens = np.asarray(serve_decode_lens())
    # edges of the split-KV decode (shared by the three decode kernels):
    # kv_len around and at whole splits of SR rows, one slot over every
    # split of a 2048-row table, 33 slots, G = 8 with softcap across splits
    SR = pdm.split_rows()
    edges = [SR - 1, SR, SR + 1, 2 * SR]
    b33 = np.random.RandomState(12).randint(1, 1500, size=33).tolist()
    g8 = [600, 2 * SR + 7, 5]
    g3 = [0, 1, 16, 17, SR, SR + 1, 2 * SR + 3]
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
        # Granite-MoE's G = 3 (24 query heads over 8): kv_len 0 and 1, a
        # page's last and first row, a split's edge; all three heads of a
        # group are checked
        ("d64_g3_edges_f32", f32, g3, 24, 8, 64, 0.0),
        ("d64_g3_edges_bf16", bf16, g3, 24, 8, 64, 0.0),
        ("d64_g3_softcap_splits_f32", f32, g8, 6, 2, 64, 30.0),
    ]
    # the bf16 kernel's plan (paged_decode_hopper.cuh) with this card's
    # grid, through its plain twin: a CTA's share ending inside a slot's
    # page run, one slot over three or more CTAs, many one-page slots in
    # one share, every slot at kv_len 0; each placement is checked on the
    # plan before its case runs.  Every bf16 case runs twice: the second
    # call must equal the first bit for bit (the item counters reset)
    pH, pKh, pD = 16, 8, 128
    ctas = pdm.hopper_ctas(pD, pH // pKh)
    grp = pdm.hopper_group(pD, pH // pKh, pKh)

    def plan_of(lens, Kh=pKh, group=grp):
        return ref.paged_decode_work_plan(lens, 16, paged_nb(lens), Kh, ctas,
                                          group)
    one_page = [1 + i % 16 for i in range(600)]
    _, pcs = plan_of(serve_lens.tolist())
    check(any(not pc.whole and pc.lo > 0 for pc in pcs),
          "paged plan: no share boundary inside a serve slot's pages")
    _, pcs = plan_of([2048])
    check(max(Counter(pc.kh for pc in pcs).values()) >= 3,
          "paged plan: the 2048-row slot spans fewer than 3 CTAs")
    _, pcs = plan_of(one_page)
    check(max(Counter(pc.cta for pc in pcs if pc.whole).values()) >= 2 * grp,
          "paged plan: no share holds two one-page slots")
    pd_cases += [
        ("plan_share_boundary_inside_pages_bf16", bf16, serve_lens.tolist(),
         pH, pKh, pD, 0.0),
        ("plan_one_slot_over_ctas_b1_2048_bf16", bf16, [2048], pH, pKh, pD,
         0.0),
        ("plan_600_one_page_slots_bf16", bf16, one_page, pH, pKh, pD, 0.0),
        ("plan_all_kv_len_0_bf16", bf16, [0] * 8, pH, pKh, pD, 0.0),
    ]
    serve_pd = None
    for name, dt, lens, H, Kh, D, cap in pd_cases:
        args = paged_inputs(torch, dev, dt, lens, H, Kh, D)
        out = ops.paged_decode_attention(*args, softcap=cap)
        want = ref.paged_decode_attention_ref(*args, softcap=cap)
        torch.cuda.synchronize()
        row = decode_record("paged_decode_attention", name, out, want,
                            dt == f32)
        if dt == bf16:
            again = ops.paged_decode_attention(*args, softcap=cap)
            torch.cuda.synchronize()
            check(bool(torch.equal(out, again)),
                  f"paged/{name}: a second call differs from the first")
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
        max_abs_err=row["max_abs_err"], tol=row["tol"], rtol=row["rtol"],
        tol_rule=row.get("tol_rule"),
        **timings(torch, lambda: ops.paged_decode_attention(*args),
                  lambda: ref.paged_decode_attention_ref(*args), library,
                  cold=True),
        **bound(nbytes, flops),
        shape=dict(B=B, H=H, Kh=Kh, D=D, P=16, live_rows=live))
    one_kernel("paged_decode_attention", report)

    # -- ragged_decode_attention (dense cache) -------------------------------
    # tolerance: f32 1e-4 (only the order of f32 sums differs), bf16 the
    # decode rule (DECODE_RULE).
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
        ("d64_g3_edges_s600_f32", f32, g3, 600, 24, 8, 64, 0.0),
        ("d64_g3_edges_s600_bf16", bf16, g3, 600, 24, 8, 64, 0.0),
    ]
    # the bf16 kernel's plan (dense_decode_hopper.cuh) with this card's
    # grid, through its plain twin: a CTA's share ending inside a slot's
    # rows, one slot over three or more CTAs, many one-chunk slots in one
    # share, every slot at kv_len 0; each placement is checked on the plan
    # before its case runs.  Every bf16 case runs twice: the second call
    # must equal the first bit for bit (the item counters reset)
    from repro_torch.kernels import ragged_decode_attention as rdm
    rctas = rdm.hopper_ctas(pD, pH // pKh)
    rrows = rdm.hopper_rows(pD, pH // pKh)
    rgrp = rdm.hopper_group(pD, pH // pKh, pKh)

    def rplan(lens, S, starts=None):
        return ref.ragged_decode_work_plan(lens, starts, S, pKh, rctas, rrows,
                                           rgrp)
    one_chunk = [1 + i % rrows for i in range(600)]
    _, pcs = rplan(serve_lens.tolist(), 2048)
    check(any(not pc.whole and pc.lo > 0 for pc in pcs),
          "dense plan: no share boundary inside a serve slot's rows")
    _, pcs = rplan([2048], 2048)
    check(max(Counter(pc.kh for pc in pcs).values()) >= 3,
          "dense plan: the 2048-row slot spans fewer than 3 CTAs")
    _, pcs = rplan(one_chunk, 64)
    check(max(Counter(pc.cta for pc in pcs if pc.whole).values()) >= 2 * rgrp,
          "dense plan: no share holds two one-chunk slots")
    rd_cases += [
        ("plan_share_boundary_inside_rows_bf16", bf16, serve_lens.tolist(),
         2048, pH, pKh, pD, 0.0),
        ("plan_one_slot_over_ctas_b1_s2048_bf16", bf16, [2048], 2048, pH, pKh,
         pD, 0.0),
        ("plan_600_one_chunk_slots_s64_bf16", bf16, one_chunk, 64, pH, pKh,
         pD, 0.0),
        ("plan_all_kv_len_0_bf16", bf16, [0] * 8, 64, pH, pKh, pD, 0.0),
    ]
    serve_rd = None
    for name, dt, lens, S, H, Kh, D, cap in rd_cases:
        args = dense_inputs(torch, dev, dt, lens, S, H, Kh, D)
        out = ops.ragged_decode_attention(*args, softcap=cap)
        want = ref.ragged_decode_attention_ref(*args, softcap=cap)
        torch.cuda.synchronize()
        row = decode_record("ragged_decode_attention", name, out, want,
                            dt == f32)
        if dt == bf16:
            repeat_equal(torch, f"ragged/{name}", out,
                         lambda a=args, c=cap: ops.ragged_decode_attention(
                             *a, softcap=c))
        if 0 in lens:
            zero = out[[i for i, n in enumerate(lens) if n == 0]]
            check(bool((zero == 0).all()), f"ragged/{name}: kv_len 0 not zero")
        if name == "serve_b32_s2048_bf16":
            serve_rd = (args, row)
        del args, out, want
    # with kv_start (a left-padded slot's rows start past its pads), at
    # Zamba2-1.2B's shared attention (D 64, G 1, 32 heads) over its
    # S = 2048 cache: kv_start 0; one live row (kv_len - 1); kv_start on
    # a split's and a chunk's first row and inside them; kv_start =
    # kv_len and a slot with kv_len 0 (zeros, checked exactly)
    ks_cases = [
        ("kv_start_0", [1500, 700, 1, 2048], [0, 0, 0, 0]),
        ("one_live_row", [1500, 700, 1, 2048], [1499, 699, 0, 2047]),
        ("on_and_inside_splits", [1500, 1500, 2048, 900],
         [SR, 2 * SR, 37, SR + 100]),
        ("at_kv_len", [1500, 700, 5, 2048], [1500, 700, 5, 2048]),
        ("kv_len_0", [0, 0, 700, 1], [0, 3, SR, 0]),
    ]
    for case, lens, starts in ks_cases:
        for dt in (bf16, f32):
            name = (f"kv_start_{case}_d64_g1_s2048_"
                    f"{'bf16' if dt == bf16 else 'f32'}")
            args = dense_inputs(torch, dev, dt, lens, 2048, 32, 32, 64)
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            out = ops.ragged_decode_attention(*args, kv_start=st)
            want = ref.ragged_decode_attention_ref(*args, kv_start=st)
            torch.cuda.synchronize()
            decode_record("ragged_decode_attention", name, out, want,
                          dt == f32)
            if dt == bf16:
                repeat_equal(torch, f"ragged/{name}", out,
                             lambda a=args, s0=st: ops.ragged_decode_attention(
                                 *a, kv_start=s0))
            empty = [i for i, (n, s0) in enumerate(zip(lens, starts))
                     if s0 >= n]
            if empty:
                check(bool((out[empty] == 0).all()),
                      f"ragged/{name}: a slot with no live row not zero")
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
        max_abs_err=row["max_abs_err"], tol=row["tol"], rtol=row["rtol"],
        tol_rule=row.get("tol_rule"),
        **timings(torch, lambda: ops.ragged_decode_attention(*args),
                  lambda: ref.ragged_decode_attention_ref(*args),
                  lambda: F.scaled_dot_product_attention(
                      q[:, :, None], kt, vt, attn_mask=mask), cold=True),
        **bound(nbytes, 4 * live * H * D),
        shape=dict(B=B, H=H, Kh=Kh, D=D, S=S, live_rows=live,
                   library="SDPA, key mask, cache pre-transposed"),
        plan=dict(ctas=rctas, rows=rrows, group=rgrp))
    one_launch(report["ragged_decode_attention"]["kernels_per_call"],
               "dense_decode_hopper_kernel", "ragged_decode_attention")
    dense_lse_checks(torch, dev, args, report)
    del args, q, kc, vc, kt, vt, mask
    release(torch)
    dense_combine_check(torch, dev)

    # -- paged_decode_attention over int8 pages -------------------------------
    # Inputs: int8 pages and per-page f32 scales from quantize_pages_ref of
    # random fp pages, and each slot's new row (k/v_new, q's dtype), which
    # both sides read unquantised in place of row kv_len - 1, as the
    # reference engine attends before it requantises.  The plain version
    # dequantises the gathered pages to f32 and runs the plain decode in
    # f32; the kernel dequantises the same values (float(q) * scale) in
    # registers and computes in f32.  f32 q: only
    # the order of the f32 sums differs, 1e-4.  bf16 q: a fixed 2e-2 (the
    # families that serve int8 pages, Nemotron, Qwen3-MoE and
    # Phi-3-Vision, are held end to end in the families phase), for the
    # reason behind the fp pages' DECODE_RULE: the plain decode, as the
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
        ("d64_g3_edges_f32", f32, g3, 24, 8, 64, 0.0, None),
        ("d64_g3_edges_bf16", bf16, g3, 24, 8, 64, 0.0, None),
    ]
    # the new row (row kv_len - 1) on the first row of a CTA's share (the
    # slot's last page opens the share and holds only the new row) and on
    # its last (the slot's pages end where the share does), placed by the
    # plan at the serve shape
    for edge in ("first", "last"):
        lens = placed_new_row(plan_of, serve_lens.tolist(), pKh, grp, edge)
        check(lens is not None,
              f"paged plan: no serve lens put the new row on a share's "
              f"{edge} row")
        if lens is not None:
            i8_cases.append((f"plan_new_row_on_share_{edge}_row_bf16", bf16,
                             lens, pH, pKh, pD, 0.0, None))
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
        if dt == bf16:
            again = ops.paged_decode_attention_int8(*args, softcap=cap, **new)
            torch.cuda.synchronize()
            check(bool(torch.equal(out, again)),
                  f"int8/{name}: a second call differs from the first")
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
                  library, cold=True),
        **bound(nbytes, 4 * live * H * D),
        shape=dict(B=B, H=H, Kh=Kh, D=D, P=P, live_rows=live,
                   live_pages=live_pages, q="bfloat16"))
    one_kernel("paged_decode_attention_int8", report)
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
        # edges of the earlier mma.sync kernel, kept: S around 64-row tiles,
        # D 64 and 128, G = H / Kh in {1, 2, 4}, window, softcap, segments
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
    # edges of the wgmma kernel's 128-row query tiles and 64-key K/V
    # tiles at every bf16 head dim, each D through every
    # mix of segments, window and softcap, G = H / Kh in {1, 4, 12, 16}
    fa_mixes = [(False, 0, 0.0), (True, 0, 0.0), (False, 40, 0.0),
                (False, 0, 30.0), (True, 40, 30.0), (True, 0, 30.0),
                (False, 100, 30.0), (True, 100, 0.0)]
    for di, D in enumerate(FLASH_BF16_DS):
        for si, S in enumerate(FLASH_EDGE_S):
            seg, win, cap = fa_mixes[(si + di) % len(fa_mixes)]
            G = (1, 4, 12, 16)[(si + 2 * di) % 4]
            fa_cases.append((
                f"edge_s{S}_d{D}_g{G}" + ("_seg" if seg else "")
                + (f"_window{win}" if win else "")
                + (f"_softcap{cap:g}" if cap else "") + "_bf16",
                bf16, 2, S, 2 * G, 2, D, seg, win, cap))
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
    # a q base 2 bytes off the 16-byte grid TMA needs: the wrapper raises
    # and the C entry refuses it (cudaErrorInvalidValue), nothing launches
    from repro_torch.kernels import flash_attention as fa_mod
    q, k, v, _ = flash_inputs(torch, dev, bf16, 1, 64, 4, 2, 128)
    qm = torch.empty(q.numel() + 8, dtype=bf16, device=dev)[1:1 + q.numel()]
    qm = qm.view(q.shape).copy_(q)
    before = ops.launch_counts()["flash_attention"]
    try:
        ops.flash_attention(qm, k, v)
        raised = False
    except ValueError:
        raised = True
    out = torch.empty_like(q)
    rc = fa_mod._bind()(qm.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                        out.data_ptr(), 1, 64, 4, 2, 128, 0, 0.0, 1,
                        build.stream_ptr(dev))
    torch.cuda.synchronize()
    refused = (raised and rc != 0
               and ops.launch_counts()["flash_attention"] == before)
    record("flash_attention", "misaligned_q_base_raises",
           0.0 if refused else math.inf, 0.0,
           {"wrapper_raised": raised, "c_entry_rc": rc})
    del q, k, v, qm, out
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
    # and exact ties must resolve to the lowest index.  Each case is called
    # twice: the second call must repeat the first bit for bit (the
    # kernel's merge order is fixed).
    fs_check = functools.partial(fused_case, torch, ops, ref, record, maxerr)

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
    # 64 rows: N 64, with k 16 and with k 1
    x64 = torch.randn((64, Dm), generator=g, device=dev).to(bf16)
    fs_check("b64_tied_bf16_k16", x64, embed.T, 16, 0.0)
    fs_check("b64_tied_bf16_k1_softcap30", x64, embed.T, 1, 30.0)
    # 70 rows: two passes over W (64 + 6 rows), each a launch
    x70 = torch.randn((70, Dm), generator=g, device=dev).to(bf16)
    before = ops.launch_counts()["fused_sample"]
    row, _ = fs_check("b70_tied_bf16_k4_two_passes", x70, embed.T, 4, 0.0)
    check(row["plan"]["passes"] == 2
          and ops.launch_counts()["fused_sample"] == before + 4,
          f"fused_sample/b70: 2 passes a call, 2 calls: {row['plan']}")
    del x33, wu16, x64, x70
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
        shape=dict(B=B, Dm=Dm, V=V, w="embed.T (strided)",
                   plan=serve_row["plan"]))
    one_launch(report["fused_sample"]["kernels_per_call"],
               "sample_wgmma_kernel", "fused_sample")
    del embed, x, w
    torch.cuda.empty_cache()
    kernels_family_shapes(torch, dev, report, record, decode_record, maxerr)
    (OUT / "chip_smoke_kernel_cases.json").write_text(
        json.dumps(cases, indent=1))
    emit({"phase": "kernels", "build_s": round(build_s, 3),
          "cases": len(cases), "cases_ok": sum(c["ok"] for c in cases),
          "timing": report})


PHI3_PATCHES = 576         # Phi-3-Vision's stub patch rows before a prompt
NO_LIBRARY_SOFTCAP = ("none: no single PyTorch call computes attention "
                      "with a tanh softcap on the scores")


def family_serve_lens(n, lo, hi, gen, seed):
    """kv_len of ``n`` slots of a families serve shape: prompts of lo-hi
    ids plus up to ``gen`` generated tokens."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return (rng.randint(lo, hi + 1, size=n)
            + rng.randint(0, gen + 1, size=n)).tolist()


def kernels_family_shapes(torch, dev, report, record, decode_record,
                          maxerr):
    """The kernels at the shapes of Gemma2-2B (D 256, G 2, softcap 50,
    window 4096, rings of 4096 and caches of 8192 rows), Qwen1.5-110B (D
    128, G 8, H 64; an untied head of 8192 x 152,064), Nemotron-4-340B
    (D 192, G 12, H 96; an untied head of 18,432 x 256,000),
    Granite-MoE-3B-A800M (D 64, G 3, H 24: fp pages, int8 pages and the
    dense cache; a tied head of 1536 x 49,155, V odd),
    Qwen3-MoE-235B-A22B (D 128, G 16, H 64; an untied head of 4096 x
    151,936), Phi-3-Vision-4.2B (D 96, G 1, H 32: flash over 576 patch
    rows and 1024 columns, fp pages and the dense cache; an untied head of
    3072 x 32,064) and Whisper-small (D 64, G 1, H 12: its decoder's
    prefill wave, its self-attention cache of 448 rows and its
    cross-attention over 1500 live rows), each held
    against its plain version with the tolerances of the Qwen3 cases (same
    arithmetic), and at edges: S not a multiple of a tile, a window smaller
    than a tile, kv_len at W and W + 1, splits' edges at D 192/256, x
    streamed for 17, 33 and 1 rows.  The serve shapes are also timed:
    ``kernel_ms``, ``ms``, the bound, the plain version and a library call
    where one PyTorch call computes the same function (none with a
    softcap), with registers and spills of their instantiations.  Rows go
    to ``report[kernel]["family_shapes"]``."""
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import paged_decode_attention as pdm
    bf16 = torch.bfloat16
    SR = pdm.split_rows()
    edges = [SR - 1, SR, SR + 1, 2 * SR]
    logs = {n: build.ptxas_report(n) for n in build.SOURCES}

    def regs(lib, pattern):
        fns = ptxas_functions(logs[lib], pattern)
        return {"functions": len(fns),
                "registers": max((v["registers"] or 0 for v in fns.values()),
                                 default=None),
                "spill_bytes": sum(v["spill_bytes"] or 0
                                   for v in fns.values())}

    def timed(kernel, case, row, fn, plain, library, nbytes, flops, shape,
              registers, note=None, plain_reps=(3, 2), cold=False,
              one=None):
        """``one``: the function name of the one kernel a call launches
        (checked on the call's profile; the profile is kept in the row)."""
        t = timings(torch, fn, plain, library, ms_reps=(5, 5),
                    plain_reps=plain_reps, cold=cold)
        if one is None:
            t.pop("kernels_per_call")
        else:
            one_launch(t["kernels_per_call"], one, f"{kernel}/{case}")
        check(registers["functions"] > 0 and registers["spill_bytes"] == 0,
              f"{kernel}/{case}: instantiation missing or spilling "
              f"{registers}")
        report[kernel].setdefault("family_shapes", []).append(dict(
            case=case, max_abs_err=row["max_abs_err"], tol=row["tol"],
            rtol=row["rtol"], tol_rule=row.get("tol_rule"),
            **t, **bound(nbytes, flops), shape=shape, registers=registers,
            library=note))

    # -- decode: paged fp pages (Qwen1.5 and Nemotron) -----------------------
    pd_cases = [
        # (case, lens, H, Kh, D, softcap, timed)
        ("nemotron_serve_b16_d192_g12", family_serve_lens(16, 64, 1024, 64, 21),
         96, 8, 192, 0.0, True),
        ("qwen1_5_serve_b32_d128_g8", family_serve_lens(32, 64, 1024, 64, 22),
         64, 8, 128, 0.0, True),
        ("d192_g12_split_edges_softcap50", edges, 96, 8, 192, 50.0, False),
        ("d192_g12_kvlen_0_1_37", [0, 1, 37], 96, 8, 192, 0.0, False),
        ("d256_g2_softcap50_splits", [17, SR + 1, 3 * SR + 5], 8, 4, 256,
         50.0, False),
        ("granite_moe_serve_b32_d64_g3",
         family_serve_lens(32, 64, 1024, 64, 24), 24, 8, 64, 0.0, True),
        ("qwen3_moe_serve_b32_d128_g16",
         family_serve_lens(32, 64, 1024, 64, 25), 64, 4, 128, 0.0, True),
        # kv_len 0, a page's last and first row, a split's edges
        ("d64_g3_page_and_split_edges", [0, 16, 17] + edges, 24, 8, 64, 0.0,
         False),
        ("d128_g16_kvlen_0_and_split_edges", [0, 1] + edges, 64, 4, 128,
         0.0, False),
        # Phi-3-Vision: every slot's rows start with its 576 patch rows
        ("phi3_vision_serve_b32_d96_g1",
         family_serve_lens(32, 64 + PHI3_PATCHES, 1024 + PHI3_PATCHES, 64,
                           26), 32, 32, 96, 0.0, True),
        ("d96_g1_kvlen_0_1_page_and_split_edges", [0, 1, 16, 17] + edges,
         32, 32, 96, 0.0, False),
    ]
    for case, lens, H, Kh, D, cap, is_timed in pd_cases:
        args = paged_inputs(torch, dev, bf16, lens, H, Kh, D)
        out = ops.paged_decode_attention(*args, softcap=cap)
        want = ref.paged_decode_attention_ref(*args, softcap=cap)
        torch.cuda.synchronize()
        row = decode_record("paged_decode_attention", case, out, want, False)
        if 0 in lens:
            zero = out[[i for i, n in enumerate(lens) if n == 0]]
            check(bool((zero == 0).all()), f"paged/{case}: kv_len 0 not zero")
        if is_timed:
            q, kp, vp, bt, kvl = args
            live = int(kvl.sum())
            G = H // Kh
            mask = (torch.arange(bt.shape[1] * 16, device=dev)[None, :]
                    < kvl[:, None])[:, None, None, :]

            def library(q=q, kp=kp, vp=vp, bt=bt, mask=mask, G=G):
                k_ = ref.gather_pages(kp, bt).transpose(1, 2) \
                    .repeat_interleave(G, 1)
                v_ = ref.gather_pages(vp, bt).transpose(1, 2) \
                    .repeat_interleave(G, 1)
                return F.scaled_dot_product_attention(q[:, :, None], k_, v_,
                                                      attn_mask=mask)
            timed("paged_decode_attention", case, row,
                  lambda a=args: ops.paged_decode_attention(*a),
                  lambda a=args: ref.paged_decode_attention_ref(*a), library,
                  4 * q.numel() + 4 * live * Kh * D + 4 * (bt.numel() + kvl.numel()),
                  4 * live * H * D,
                  dict(B=len(lens), H=H, Kh=Kh, D=D, P=16, live_rows=live),
                  regs("paged_decode_attention",
                       rf"paged_decode_hopper_kernelI13__nv_bfloat16Li{D}ELi"
                       rf"{G}E"),
                  note="gather + SDPA, key mask", cold=True)
        del args, out, want

    # -- decode: the dense cache (Gemma2's rings and global caches) ---------
    g2_kv = family_serve_lens(16, 512, 6144, 64, 23)
    rd_cases = [
        # (case, S, lens, H, Kh, D, softcap, timed)
        ("gemma2_ring_b16_s4096", 4096, [min(n + 1, 4096) for n in g2_kv],
         8, 4, 256, 50.0, True),
        ("gemma2_global_b16_s8192", 8192, [n + 1 for n in g2_kv], 8, 4, 256,
         50.0, True),
        ("kvlen_at_w_and_w_plus_1_s4096", 4096, [4096, 4097, 1, 0], 8, 4,
         256, 50.0, False),
        ("d256_split_edges_s700", 700, edges[:3] + [700], 8, 4, 256, 50.0,
         False),
        ("d192_g12_s700", 700, [600, SR + 1, 5], 96, 8, 192, 0.0, False),
        ("granite_moe_serve_b32_s2048_d64_g3", 2048,
         family_serve_lens(32, 64, 1024, 64, 24), 24, 8, 64, 0.0, True),
        ("qwen3_moe_serve_b32_s2048_d128_g16", 2048,
         family_serve_lens(32, 64, 1024, 64, 25), 64, 4, 128, 0.0, True),
        ("d64_g3_edges_s300", 300, [0, 1, 16, 17, 299, 300], 24, 8, 64, 0.0,
         False),
        ("d128_g16_split_edges_s700", 700, [0] + edges[:3] + [700], 64, 4,
         128, 0.0, False),
        ("phi3_vision_dense_b16_s2048_d96_g1", 2048,
         family_serve_lens(16, 64 + PHI3_PATCHES, 1024 + PHI3_PATCHES, 64,
                           27), 32, 32, 96, 0.0, True),
        ("d96_g1_kvlen_0_1_page_and_split_edges_s700", 700,
         [0, 1, 16, 17] + edges[:3] + [700], 32, 32, 96, 0.0, False),
        # Whisper-small's decode: the decoder's own cache (448 rows,
        # prompts of 16-224 ids plus up to 64 tokens and the new row) and
        # the cross K/V of the encoder's 1500 rows, every row live
        ("whisper_self_b32_s448_d64_g1", 448,
         [n + 1 for n in family_serve_lens(32, 16, 224, 64, 28)], 12, 12,
         64, 0.0, True),
        ("whisper_cross_b32_s1500_d64_g1", 1500, [1500] * 32, 12, 12, 64,
         0.0, True),
        ("s1500_d64_g1_kvlen_0_1_and_split_edges", 1500,
         [0, 1] + edges[:3] + [1499, 1500], 12, 12, 64, 0.0, False),
        # the launch path's serve steps: Qwen3-0.6B at decode_32k (B 8,
        # cache rows _round_len(32,768 + 8); the first step reads kv_len =
        # S - 8 rows and the new one) and Gemma2-2B's global layers at
        # long_500k (524,800 rows, 2,050 splits a slot, each merged),
        # then their edges: kv_len 0, 1, a split's edge, every row live
        ("qwen3_decode_32k_b8_s33280_d128_g2", 33_280, [32_761] * 8, 16, 8,
         128, 0.0, True),
        ("s33280_d128_g2_kvlen_0_1_split_edge_full", 33_280,
         [0, 1, SR, SR + 1, 33_279, 33_280], 16, 8, 128, 0.0, False),
        ("gemma2_long_500k_b1_s524800_d256_g2_softcap50", 524_800,
         [524_281], 8, 4, 256, 50.0, True),
        ("s524800_d256_g2_softcap50_full_and_one", 524_800, [524_800, 1],
         8, 4, 256, 50.0, False),
    ]
    for case, S, lens, H, Kh, D, cap, is_timed in rd_cases:
        args = dense_inputs(torch, dev, bf16, lens, S, H, Kh, D)
        out = ops.ragged_decode_attention(*args, softcap=cap)
        want = ref.ragged_decode_attention_ref(*args, softcap=cap)
        torch.cuda.synchronize()
        row = decode_record("ragged_decode_attention", case, out, want,
                            False)
        repeat_equal(torch, f"ragged/{case}", out,
                     lambda a=args, c=cap: ops.ragged_decode_attention(
                         *a, softcap=c))
        if 0 in lens:
            zero = out[[i for i, n in enumerate(lens) if n == 0]]
            check(bool((zero == 0).all()), f"ragged/{case}: kv_len 0 not zero")
        if is_timed:
            q, kc, vc, kvl = args
            live = int(kvl.clamp(max=S).sum())
            library, note = None, NO_LIBRARY_SOFTCAP
            if cap == 0:
                G = H // Kh
                kt = kc.transpose(1, 2).repeat_interleave(G, 1)
                vt = vc.transpose(1, 2).repeat_interleave(G, 1)
                mask = (torch.arange(S, device=dev)[None, :]
                        < kvl[:, None])[:, None, None, :]

                def library(q=q, kt=kt, vt=vt, mask=mask):
                    return F.scaled_dot_product_attention(
                        q[:, :, None], kt, vt, attn_mask=mask)
                note = "SDPA, key mask, cache pre-transposed"
            timed("ragged_decode_attention", case, row,
                  lambda a=args, c=cap: ops.ragged_decode_attention(
                      *a, softcap=c),
                  lambda a=args, c=cap: ref.ragged_decode_attention_ref(
                      *a, softcap=c), library,
                  4 * q.numel() + 4 * live * Kh * D + 4 * kvl.numel(),
                  4 * live * H * D,
                  dict(B=len(lens), H=H, Kh=Kh, D=D, S=S, live_rows=live,
                       softcap=cap),
                  regs("ragged_decode_attention",
                       rf"dense_decode_hopper_kernelILi{D}ELi{H // Kh}E"),
                  note=note, cold=True, one="dense_decode_hopper_kernel")
            del library
        del args, out, want
        torch.cuda.empty_cache()

    # -- decode: Zamba2-1.2B's shared attention (dense, kv_start) ------------
    # 32 slots of prompts of 64-1024 ids left-padded to the 1024 bucket
    # plus up to 64 generated tokens and the new row: rows [kv_start,
    # kv_len) live, kv_start = 1024 - prompt length.  Bound: the bytes of
    # the live rows.  Yardstick: SDPA with the [kv_start, kv_len) key mask.
    import numpy as np
    z_lens, z_starts = zamba2_serve_rows()
    H, Kh, D, S = 32, 32, 64, 2048
    args = dense_inputs(torch, dev, bf16, z_lens, S, H, Kh, D)
    st = torch.tensor(z_starts, dtype=torch.int32, device=dev)
    out = ops.ragged_decode_attention(*args, kv_start=st)
    want = ref.ragged_decode_attention_ref(*args, kv_start=st)
    torch.cuda.synchronize()
    case = "zamba2_serve_b32_s2048_d64_g1_kv_start"
    row = decode_record("ragged_decode_attention", case, out, want, False)
    repeat_equal(torch, f"ragged/{case}", out,
                 lambda: ops.ragged_decode_attention(*args, kv_start=st))
    q, kc, vc, kvl = args
    live = int((kvl - st).sum())
    pos = torch.arange(S, device=dev)[None, :]
    mask = ((pos < kvl[:, None]) & (pos >= st[:, None]))[:, None, None, :]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    timed("ragged_decode_attention", case, row,
          lambda: ops.ragged_decode_attention(*args, kv_start=st),
          lambda: ref.ragged_decode_attention_ref(*args, kv_start=st),
          lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                                 attn_mask=mask),
          4 * q.numel() + 4 * live * Kh * D + 8 * kvl.numel(),
          4 * live * H * D,
          dict(B=32, H=H, Kh=Kh, D=D, S=S, live_rows=live,
               kv_start="1024 - prompt length"),
          regs("ragged_decode_attention",
               r"dense_decode_hopper_kernelILi64ELi1E"),
          note="SDPA, [kv_start, kv_len) key mask, cache pre-transposed",
          cold=True, one="dense_decode_hopper_kernel")
    del args, q, kc, vc, kvl, kt, vt, mask, out, want, st

    # -- decode: int8 pages at the paged families' heads ----------------------
    # Granite-MoE's G 3, Nemotron's (192, 12), Qwen3-MoE's (128, 16) and
    # Phi-3-Vision's (96, 1, rows padded to 8 chunks in shared memory), at
    # each serve shape and at its edges: kv_len 0 and 1, a page's last
    # (16) and first (17) row as the slot's new row, both sides of a
    # split, and one slot's second page all zero (its scale at the 1e-8
    # floor).  The tolerance of the Qwen3 int8 cases: bf16 q 2e-2.
    for case, lens, H, Kh, D, is_timed, zero_slot in (
            ("granite_moe_serve_b32_d64_g3",
             family_serve_lens(32, 64, 1024, 64, 24), 24, 8, 64, True, None),
            ("d64_g3_new_row_on_page_and_split_edges",
             [1, 16, 17] + edges, 24, 8, 64, False, None),
            ("nemotron_serve_b16_d192_g12",
             family_serve_lens(16, 64, 1024, 64, 21), 96, 8, 192, True, None),
            ("qwen1_5_serve_b32_d128_g8",
             family_serve_lens(32, 64, 1024, 64, 22), 64, 8, 128, True, None),
            ("qwen3_moe_serve_b32_d128_g16",
             family_serve_lens(32, 64, 1024, 64, 25), 64, 4, 128, True, None),
            ("phi3_vision_serve_b32_d96_g1",
             family_serve_lens(32, 64 + PHI3_PATCHES, 1024 + PHI3_PATCHES, 64,
                               26), 32, 32, 96, True, None)) + tuple(
            (f"d{D_}_g{G_}_kvlen_0_1_page_split_edges_zero_page",
             [0, 1, 16, 17, 40] + edges, G_ * Kh_, Kh_, D_, False, 4)
            for D_, G_, Kh_ in ((192, 12, 8), (128, 16, 4), (96, 1, 32))):
        q, kp, vp, bt, kvl = paged_inputs(torch, dev, bf16, lens, H, Kh, D)
        if zero_slot is not None:
            kp[bt[zero_slot, 1]] = 0
            vp[bt[zero_slot, 1]] = 0
        args = int8_inputs(ref, (q, kp, vp, bt, kvl))
        del q, kp, vp, bt, kvl
        gn = torch.Generator(device=dev).manual_seed(len(lens))
        new = {n: torch.randn((len(lens), Kh, D), generator=gn,
                              device=dev).to(bf16) for n in ("k_new", "v_new")}
        out = ops.paged_decode_attention_int8(*args, **new)
        want = ref.paged_decode_attention_int8_ref(*args, **new)
        torch.cuda.synchronize()
        row = record("paged_decode_attention_int8", case, maxerr(out, want),
                     2e-2)
        if zero_slot is not None:
            pg = args[5][zero_slot, 1]
            check(all(abs(float(sc_[pg]) * 127 - 1e-8) < 1e-12
                      for sc_ in args[3:5]),
                  f"int8/{case}: zero page's scales not at their 1e-8 floor")
        if 0 in lens:
            zero = out[[i for i, n in enumerate(lens) if n == 0]]
            check(bool((zero == 0).all()), f"int8/{case}: kv_len 0 not zero")
        if is_timed:
            q, k8, v8, ks, vs, bt, kvl = args
            G, P = H // Kh, k8.shape[1]
            live = int(kvl.sum())
            live_pages = sum(-(-int(n) // P) for n in kvl.tolist())
            mask = (torch.arange(bt.shape[1] * P, device=dev)[None, :]
                    < kvl[:, None])[:, None, None, :]

            def library(q=q, k8=k8, v8=v8, ks=ks, vs=vs, bt=bt, mask=mask,
                        G=G, P=P):
                def deq(pages, scales):
                    g = ref.gather_pages(pages, bt).float() * scales[
                        bt.long()].repeat_interleave(P, 1)[:, :, None, None]
                    return g.to(q.dtype).transpose(1, 2) \
                        .repeat_interleave(G, 1)
                return F.scaled_dot_product_attention(
                    q[:, :, None], deq(k8, ks), deq(v8, vs), attn_mask=mask)
            B = len(lens)
            timed("paged_decode_attention_int8", case, row,
                  lambda a=args, n=new: ops.paged_decode_attention_int8(
                      *a, **n),
                  lambda a=args, n=new: ref.paged_decode_attention_int8_ref(
                      *a, **n), library,
                  4 * q.numel() + 2 * (live - B) * Kh * D + 4 * B * Kh * D
                  + 8 * live_pages + 4 * (bt.numel() + kvl.numel()),
                  4 * live * H * D,
                  dict(B=B, H=H, Kh=Kh, D=D, P=P, live_rows=live,
                       live_pages=live_pages),
                  regs("paged_decode_attention",
                       rf"paged_decode_hopper_kernelIaLi{D}ELi{G}E"),
                  note="gather + dequantise + SDPA, key mask", cold=True)
        del args, new, out, want

    # -- flash prefill ----------------------------------------------------------
    # The serve shapes are the families' prefill waves (16 x 8192 for
    # Gemma2, 32 x 1024 for Qwen1.5, 16 x 1024 for Nemotron): one launch
    # at the whole wave, held against the plain version two batch rows at
    # a time (rows are independent; slices bound the check's memory).
    # The plain version is full_attention's arithmetic at every S
    # (``flash_attention_rows_ref``): above 2048 rows the wrappers' plain
    # version attends blockwise and rounds q/sqrt(D) to bf16 as the
    # reference's long path does, which moves a row over a few keys by
    # up to 0.0067 from an f64 attention where the kernel (q/sqrt(D) in
    # f32) moved 0.0045 (S = 2049, row 3; H100 80GB HBM3 at 700 W).
    fa_rtol, fa_p, fa_rows = 2.0 ** -7, 2.0 ** -9, 2
    fa_cases = [
        # (case, B, S, H, Kh, D, seg, window, softcap, timed)
        ("gemma2_local_b16_s8192_w4096_softcap50", 16, 8192, 8, 4, 256,
         False, 4096, 50.0, True),
        ("gemma2_global_b16_s8192_softcap50", 16, 8192, 8, 4, 256, False, 0,
         50.0, True),
        ("nemotron_b16_s1024_d192_g12", 16, 1024, 96, 8, 192, False, 0, 0.0,
         True),
        ("qwen1_5_b32_s1024_d128_g8", 32, 1024, 64, 8, 128, False, 0, 0.0,
         True),
        ("s100_d256_window20_softcap50", 2, 100, 8, 4, 256, False, 20, 50.0,
         False),
        ("s33_d192_g12_seg", 2, 33, 96, 8, 192, True, 0, 0.0, False),
        ("s65_d256_g2", 2, 65, 8, 4, 256, False, 0, 0.0, False),
        ("s97_d192_window40_softcap30", 1, 97, 24, 2, 192, False, 40, 30.0,
         False),
        ("s2049_d256_window100_softcap50", 1, 2049, 8, 4, 256, False, 100,
         50.0, False),
        ("granite_moe_b32_s1024_d64_g3", 32, 1024, 24, 8, 64, False, 0, 0.0,
         True),
        ("qwen3_moe_b32_s1024_d128_g16", 32, 1024, 64, 4, 128, False, 0,
         0.0, True),
        ("s65_d64_g3_seg", 2, 65, 24, 8, 64, True, 0, 0.0, False),
        ("s129_d128_g16_window40", 1, 129, 64, 4, 128, False, 40, 0.0,
         False),
        # Phi-3-Vision's prefill wave: 576 patch rows before a bucketed
        # width of 1024; the edges of the 16-chunk pitch (rows 8-15 of a
        # tile's swizzle), ragged S, segments, a window
        ("phi3_vision_b32_s1600_d96_g1", 32, PHI3_PATCHES + 1024, 32, 32, 96,
         False, 0, 0.0, True),
        ("s16_d96_swizzle_rows_8_15", 2, 16, 32, 32, 96, False, 0, 0.0,
         False),
        ("s33_d96", 2, 33, 32, 32, 96, False, 0, 0.0, False),
        ("s65_d96_seg", 2, 65, 32, 32, 96, True, 0, 0.0, False),
        ("s97_d96", 1, 97, 32, 32, 96, False, 0, 0.0, False),
        ("s129_d96_window40_softcap30", 1, 129, 32, 32, 96, False, 40, 30.0,
         False),
        # Whisper-small's decoder prefill wave (prompts of up to 224 ids)
        ("whisper_b32_s256_d64_g1", 32, 256, 12, 12, 64, False, 0, 0.0,
         True),
        # Zamba2-1.2B's shared attention over its left-padded prefill
        # wave (prompts of 64-1024 ids in the 1024 bucket; seg ids pads
        # 0, tokens 1), and 0, 1 and S - 1 pad columns in three rows at
        # S 16, 33, 1024 and 2048 (a row of pads attends its own pad
        # keys and stays finite)
        ("zamba2_b32_s1024_d64_g1_left_pad", 32, 1024, 32, 32, 64,
         (1024 - np.random.RandomState(30).randint(64, 1025, size=32))
         .tolist(), 0, 0.0, True),
        # the launch path's prefill step: Qwen3-0.6B at prefill_32k (B 1),
        # and a ragged last tile at that length
        ("qwen3_prefill_32k_b1_s32768_d128_g2", 1, 32_768, 16, 8, 128,
         False, 0, 0.0, True),
        ("s32767_d128_g2", 1, 32_767, 16, 8, 128, False, 0, 0.0, False),
    ] + [(f"s{S_}_d64_g1_left_pad_0_1_all_but_one", 3, S_, 32, 32, 64,
          [0, 1, S_ - 1], 0, 0.0, False) for S_ in (16, 33, 1024, 2048)]
    for case, B, S, H, Kh, D, seg, win, cap, is_timed in fa_cases:
        q, k, v, s_ = flash_inputs(torch, dev, bf16, B, S, H, Kh, D,
                                   seg is True)
        if isinstance(seg, list):          # left pads: 0 before 1
            s_ = (torch.arange(S, device=dev)[None] >= torch.tensor(
                seg, device=dev)[:, None]).to(torch.int32).contiguous()
        out = ops.flash_attention(q, k, v, seg_ids=s_, window=win,
                                  softcap=cap)
        err, excess, amax = 0.0, -math.inf, 0.0
        for b0 in range(0, B, fa_rows):
            sl = slice(b0, b0 + fa_rows)
            seg = None if s_ is None else s_[sl]
            want = ref.flash_attention_rows_ref(q[sl], k[sl], v[sl],
                                                window=win, softcap=cap,
                                                seg_ids=seg)
            wabs = ref.flash_attention_rows_ref(q[sl], k[sl], v[sl].abs(),
                                                window=win, softcap=cap,
                                                seg_ids=seg).float()
            o = out[sl].float()
            err = max(err, maxerr(o, want))
            excess = max(excess, float(((o - want.float()).abs()
                                        - fa_rtol * want.float().abs()
                                        - fa_p * wabs).max()))
            amax = max(amax, float(wabs.max()))
            del want, wabs, o
        torch.cuda.synchronize()
        row = record("flash_attention", case, err, 1e-3,
                     {"p_rounding": "2^-9*attn(|v|)",
                      "max_attn_abs_v": amax, "checked_rows_at_a_time":
                      min(B, fa_rows)},
                     excess=excess, rtol=fa_rtol)
        if isinstance(seg, list):
            check(bool(torch.isfinite(out).all()),
                  f"flash_attention/{case}: a row of pads not finite")
        del out
        if is_timed and isinstance(seg, list):
            # SDPA with the causal and left-pad masks as one boolean mask
            pos = torch.arange(S, device=dev)
            mask = ((pos[None, :, None] >= pos[None, None, :])
                    & (s_[:, :, None] == s_[:, None, :]))[:, None]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            timed("flash_attention", case, row,
                  lambda a=(q, k, v), sg=s_: ops.flash_attention(
                      *a, seg_ids=sg),
                  lambda a=(q, k, v), sg=s_: ref.flash_attention_ref(
                      *a, seg_ids=sg),
                  lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=mask),
                  (2 * q.numel() + k.numel() + v.numel()) * 2 + 4 * B * S,
                  4 * D * H * visible_pairs(S, 0, s_.cpu().numpy()),
                  dict(B=B, S=S, H=H, Kh=Kh, D=D, left_pads=seg),
                  regs("flash_attention", rf"flash_wgmma_kernelILi{D}E"),
                  note="SDPA, causal and left-pad mask as one boolean mask",
                  plain_reps=(2, 1))
            del qt, kt, vt, mask
        elif is_timed:
            library, note = None, NO_LIBRARY_SOFTCAP
            if cap == 0 and win == 0:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                kt = kt.repeat_interleave(H // Kh, 1)
                vt = vt.repeat_interleave(H // Kh, 1)

                def library(qt=qt, kt=kt, vt=vt):
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
                note = "SDPA, causal, kv heads pre-expanded"
            timed("flash_attention", case, row,
                  lambda a=(q, k, v), w_=win, c=cap: ops.flash_attention(
                      *a, window=w_, softcap=c),
                  lambda a=(q, k, v), w_=win, c=cap: ref.flash_attention_ref(
                      *a, window=w_, softcap=c), library,
                  (2 * q.numel() + k.numel() + v.numel()) * 2,
                  4 * D * H * B * visible_pairs(S, win, None),
                  dict(B=B, S=S, H=H, Kh=Kh, D=D, window=win, softcap=cap),
                  regs("flash_attention", rf"flash_wgmma_kernelILi{D}E"),
                  note=note, plain_reps=(2, 1))
        del q, k, v, s_
        torch.cuda.empty_cache()

    # -- the fused head at the families' heads ---------------------------------
    def fs_case(case, x, w, k, cap):
        row = fused_case(torch, ops, ref, record, maxerr, case, x, w, k,
                         cap)[0]
        check(row["plan"]["passes"] == 1,
              f"fused_sample/{case}: W read more than once {row['plan']}")
        return row

    def fs_regs(row, tied):
        """Registers of the instantiation the plan runs."""
        return regs("fused_sample", rf"sample_wgmma_kernelILi"
                    rf"{row['plan']['n']}ELb{int(tied)}E")

    g = torch.Generator(device=dev).manual_seed(31)
    for Dm, V, B, model in ((8192, 152064, 32, "qwen1_5"),
                            (18432, 256000, 16, "nemotron")):
        w = (torch.randn((Dm, V), generator=g, device=dev)
             / math.sqrt(Dm)).to(bf16)
        x = torch.randn((B, Dm), generator=g, device=dev).to(bf16)
        case = f"{model}_b{B}_dm{Dm}_v{V}_untied_k1"
        row = fs_case(case, x, w, 1, 0.0)
        if Dm == 8192:
            x33 = torch.randn((33, Dm), generator=g, device=dev).to(bf16)
            fs_case("dm8192_b17_k8_softcap30", x33[:17], w, 8, 30.0)
            fs_case("dm8192_b33_k16", x33, w, 16, 0.0)
            tied = (torch.randn((5000, Dm), generator=g, device=dev)
                    / math.sqrt(Dm)).to(bf16).T
            fs_case("dm8192_tied_b8_v5000_k8", x33[:8], tied, 8, 0.0)
            del x33, tied
        else:
            fs_case("dm18432_b1_k4_softcap30", x[:1], w, 4, 30.0)

        def library(x=x, w=w):
            logits = torch.matmul(x, w).float()
            return torch.topk(logits, 1), torch.logsumexp(logits, -1)
        timed("fused_sample", case, row,
              lambda x=x, w=w: ops.fused_sample(x, w),
              lambda x=x, w=w: ref.fused_sample_ref(x, w), library,
              V * Dm * 2 + B * Dm * 2 + B * 3 * 4, 2 * B * Dm * V,
              dict(B=B, Dm=Dm, V=V, w="lm_head (untied, v contiguous)",
                   plan=row["plan"]),
              fs_regs(row, False), note="matmul + topk + logsumexp",
              plain_reps=(2, 1))
        del w, x, library
        torch.cuda.empty_cache()

    # the MoE family's heads: Granite's tied embedding (V = 49,155, odd:
    # the vocab tail inside a tile) at B 32, 1 and 33, Qwen3-MoE's untied
    # 4096 x 151,936; Phi-3-Vision's untied 3072 x 32,064 at B 32, 1, 33
    for Dm, V, model, tied in ((1536, 49155, "granite_moe", True),
                               (4096, 151936, "qwen3_moe", False),
                               (3072, 32064, "phi3_vision", False)):
        shape = (V, Dm) if tied else (Dm, V)
        w = (torch.randn(shape, generator=g, device=dev)
             / math.sqrt(Dm)).to(bf16)
        if tied:
            w = w.T
        x = torch.randn((33, Dm), generator=g, device=dev).to(bf16)
        kind = "tied" if tied else "untied"
        case = f"{model}_b32_dm{Dm}_v{V}_{kind}_k1"
        row = fs_case(case, x[:32], w, 1, 0.0)
        if tied or model == "phi3_vision":
            fs_case(f"{model}_b1_v{V}_{kind}_k1", x[:1], w, 1, 0.0)
            fs_case(f"{model}_b33_v{V}_{kind}_k8", x, w, 8, 0.0)
        if model == "qwen3_moe":            # N 64: one pass
            x64 = torch.randn((64, Dm), generator=g, device=dev).to(bf16)
            fs_case(f"{model}_b64_v{V}_{kind}_k1", x64, w, 1, 0.0)
            fs_case(f"{model}_b64_v{V}_{kind}_k16_softcap30", x64, w, 16,
                    30.0)
            del x64
        xs = x[:32]

        def library(x=xs, w=w):
            logits = torch.matmul(x, w).float()
            return torch.topk(logits, 1), torch.logsumexp(logits, -1)
        timed("fused_sample", case, row,
              lambda x=xs, w=w: ops.fused_sample(x, w),
              lambda x=xs, w=w: ref.fused_sample_ref(x, w), library,
              V * Dm * 2 + 32 * Dm * 2 + 32 * 3 * 4, 2 * 32 * Dm * V,
              dict(B=32, Dm=Dm, V=V, w=("embed.T (tied)" if tied else
                                        "lm_head (untied, v contiguous)"),
                   plan=row["plan"]),
              fs_regs(row, tied), note="matmul + topk + logsumexp",
              plain_reps=(2, 1))
        del w, x, xs, library
        torch.cuda.empty_cache()


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
    hop = (csrc / "paged_decode_hopper.cuh").read_text()
    rd = (csrc / "ragged_decode_attention.cu").read_text()
    dd = (csrc / "dense_decode_hopper.cuh").read_text()

    def sub(src, *pairs):
        for a, b in pairs:
            if a not in src:
                raise ValueError(f"variant edit not found: {a[:60]!r}")
            src = src.replace(a, b)
        return src

    def decode(*pairs, cu_pairs=()):
        return ("paged_decode_attention",
                {"paged_decode_attention.cu": sub(pd, *cu_pairs),
                 "paged_decode_hopper.cuh": sub(hop, *pairs)})
    def dense(*pairs, cu_pairs=()):
        return ("ragged_decode_attention",
                {"ragged_decode_attention.cu": sub(rd, *cu_pairs),
                 "dense_decode_hopper.cuh": sub(dd, *pairs)})
    # bf16 q back to the split-KV body of decode_attention.cuh (the dense
    # kernel before this design), its bf16 shapes instantiated there again
    dense_body = ((
        "#define RT_LAUNCH(DD, GG) (int)launch_decode<T, T, DD, GG, true>"
        "(p, B, s)\n  RT_DECODE_SHAPES(D, G, RT_LAUNCH)\n",
        "#define RT_LAUNCH(DD, GG) (int)launch_decode<T, T, DD, GG, true>"
        "(p, B, s)\n  RT_DECODE_SHAPES(D, G, RT_LAUNCH)\n"
        "  if constexpr (std::is_same<T, __nv_bfloat16>::value) {\n"
        "    RT_DECODE_WIDE_SHAPES(D, G, RT_LAUNCH)\n"
        "  }\n"), (
        "  if (dtype == kBF16) {\n    if (ws == nullptr",
        "  if (false) {\n    if (ws == nullptr"), (
        "  if (dtype != kF32) return (int)cudaErrorInvalidValue;\n"
        "  DecodeParams p{};",
        "  DecodeParams p{};"), (
        "  p.row_stride = (long long)Kh * D * 4;",
        "  p.row_stride = (long long)Kh * D * (dtype == kF32 ? 4 : 2);"), (
        "  return dispatch<float>(D, G, p, B, s);\n}",
        "  if (dtype == kBF16) return dispatch<__nv_bfloat16>(D, G, p, B, s);"
        "\n  return dispatch<float>(D, G, p, B, s);\n}"))
    cfg = "kFlashConsumers = 2, kFlashStages = 2"
    tile = "TK = 64;"
    qk = ("        qk_issue<D>(sc, qd, kd + ((slot(it) * T::kKVBytes) >> 4));"
          "\n")
    pv = ("        pv_issue<D>(o, pa, vd + ((slot(it - 1) * T::kKVBytes) >> 4));"
          "\n")
    ex = "sc[i] = fast_exp2(fmaf(sc[i], mul, -ms));"
    stages = "kPdMaxStages = 4;"
    scores = ("        mma_bf16(sa, a, r[0], r[2]);\n"
              "        mma_bf16(sb, a, r[1], r[3]);\n")
    pvs = ("        mma_bf16(o[2 * cg], ah, r[0], r[1]);\n"
           "        mma_bf16(o[2 * cg], al, r[0], r[1]);\n"
           "        mma_bf16(o[2 * cg + 1], ah, r[2], r[3]);\n"
           "        mma_bf16(o[2 * cg + 1], al, r[2], r[3]);\n")
    # bf16 q back to the split-KV body of decode_attention.cuh (the
    # kernel before this design), every bf16 shape instantiated there again
    old_body = ((
        "template <typename T, typename KV>\n"
        "int dispatch(int D, int G, DecodeParams& p, int B, cudaStream_t s) {\n"
        "#define RT_LAUNCH(DD, GG) (int)launch_decode<T, KV, DD, GG>(p, B, s)\n"
        "  RT_DECODE_SHAPES(D, G, RT_LAUNCH)\n",
        "template <typename T, typename KV>\n"
        "int dispatch(int D, int G, DecodeParams& p, int B, cudaStream_t s) {\n"
        "#define RT_LAUNCH(DD, GG) (int)launch_decode<T, KV, DD, GG>(p, B, s)\n"
        "  RT_DECODE_SHAPES(D, G, RT_LAUNCH)\n"
        "  if constexpr (std::is_same<T, __nv_bfloat16>::value) {\n"
        "    if constexpr (std::is_same<KV, T>::value) {\n"
        "      RT_DECODE_WIDE_SHAPES(D, G, RT_LAUNCH)\n"
        "    } else {\n"
        "      RT_DECODE_INT8_WIDE_SHAPES(D, G, RT_LAUNCH)\n"
        "    }\n"
        "  }\n"), (
        "  if (dtype == kBF16) {\n    if (P != kPdPage",
        "  if (false) {\n    if (P != kPdPage"), (
        "  if (dtype != kF32) return (int)cudaErrorInvalidValue;\n"
        "  const int kv_size = kv_dtype == kF32 ? 4 : 1;",
        "  const int kv_size = kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;"), (
        "  if (kv_dtype == kI8) return dispatch<float, int8_t>(D, G, p, B, s);\n",
        "  if (dtype == kBF16 && kv_dtype == kBF16)\n"
        "    return dispatch<__nv_bfloat16, __nv_bfloat16>(D, G, p, B, s);\n"
        "  if (dtype == kBF16 && kv_dtype == kI8)\n"
        "    return dispatch<__nv_bfloat16, int8_t>(D, G, p, B, s);\n"
        "  if (kv_dtype == kI8) return dispatch<float, int8_t>(D, G, p, B, s);\n"))
    return {
        "flash_attention/shipped": ("flash_attention", {
            "flash_attention.cu": fa}),
        "flash_attention/3_stage_ring": ("flash_attention", {
            "flash_attention.cu": sub(
                fa, (cfg, cfg.replace("kFlashStages = 2",
                                      "kFlashStages = 3")))}),
        # 64 query rows a CTA (256 threads, no register split)
        "flash_attention/1_consumer_warpgroup": ("flash_attention", {
            "flash_attention.cu": sub(
                fa, (cfg, cfg.replace("kFlashConsumers = 2",
                                      "kFlashConsumers = 1")))}),
        "flash_attention/128_key_tile": ("flash_attention", {
            "flash_attention.cu": sub(
                fa, (tile, "TK = D > 128 ? 64 : 128;"))}),
        # the scores zeroed where Q K^T was issued: the masks, softmax
        # and P V still run
        "flash_attention/ablate_qk_product": ("flash_attention", {
            "flash_attention.cu": sub(
                fa, (qk, "        for (float& x : sc) x = 0.f;\n"))}),
        "flash_attention/ablate_pv_product": ("flash_attention", {
            "flash_attention.cu": sub(fa, (pv, ""))}),
        "flash_attention/ablate_exp": ("flash_attention", {
            "flash_attention.cu": sub(
                fa, (ex, "sc[i] = fmaf(sc[i], mul, -ms);"))}),
        # the fused head (its plan's choices are arguments of the shipped
        # build, `fused_head_variants`): the shipped source, the same
        # source built again (the spread of identical builds), and the
        # design it replaced (mma.sync on a cp.async ring, x staged or
        # streamed beside W, a second launch to merge), kept in
        # tools/variants/
        "fused_sample/shipped": ("fused_sample", {"fused_sample.cu": fs}),
        "fused_sample/shipped_again": ("fused_sample", {
            "fused_sample.cu": fs + "\n// the shipped source, built again\n"}),
        "fused_sample/mma_sync_design": ("fused_sample", {
            "fused_sample.cu": (ROOT / "tools" / "variants"
                                / "fused_sample_mma_sync.cu").read_text()}),
        "paged_decode/shipped": decode(),
        "paged_decode/split_body": decode(cu_pairs=old_body),
        # pages in each warp's ring at 4 warps (4 shipped; 6 where the
        # ring fits) and at 8 (2 shipped)
        "paged_decode/2_stage_ring": decode((stages, "kPdMaxStages = 2;")),
        "paged_decode/3_stage_ring": decode((stages, "kPdMaxStages = 3;")),
        "paged_decode/6_stage_ring": decode((stages, "kPdMaxStages = 6;")),
        "paged_decode/8_warps_4_stage_ring": decode(
            ("kPdNarrowStages = 2;", "kPdNarrowStages = 4;")),
        # 4 warps a CTA and half the rings' bytes: 2 CTAs an SM (8 warps
        # at ~200 registers a thread fit one)
        "paged_decode/2_ctas_an_sm": decode(
            ("kPdRing = 212992;", "kPdRing = 106496;"),
            ("constexpr int kPdWarps = 8;", "constexpr int kPdWarps = 4;")),
        # 4 warps (KV heads a unit) at every shape
        "paged_decode/4_warps": decode(
            ("constexpr int kPdWarps = 8;", "constexpr int kPdWarps = 4;")),
        # the S = Q K^T products removed (bf16 pages; scores stay 0), and the
        # P V products removed (bf16 pages)
        "paged_decode/ablate_scores": decode((scores, "")),
        "paged_decode/ablate_pv": decode((pvs, "")),
        # the dense decode (timed by ``dense_decode_variants``): the shipped
        # source, the same source built again (the spread of identical
        # builds), the split-KV body it replaced; units in each warp's ring
        # (2 shipped; 3 where they fit)
        "ragged_decode/shipped": dense(),
        "ragged_decode/shipped_again": dense(
            ("#pragma once\n", "#pragma once\n// built again\n")),
        "ragged_decode/split_body": dense(cu_pairs=dense_body),
        "ragged_decode/3_stage_ring": dense(
            ("kDdMaxStages = 2;", "kDdMaxStages = 3;")),
        # the weights in two bf16 terms (16 bits), not three
        "ragged_decode/two_weight_terms": dense((
            "        mma_bf16(o[cg], a, am[0], am[2]);\n", ""), (
            "        mma_bf16(o[2 * cg], am, r[0], r[1]);\n", ""), (
            "        mma_bf16(o[2 * cg + 1], am, r[2], r[3]);\n", ""), (
            "  lo = pack_bf16(ra - bf_lo(mid), rb - bf_hi(mid));",
            "  lo = mid;\n  mid = 0u;")),
        # every split item merged by all the CTAs holding its pieces, and
        # none (the completing CTA merges every item)
        "ragged_decode/spread_every_item": dense(
            ("kDdSpreadPieces = 33;", "kDdSpreadPieces = 2;")),
        "ragged_decode/spread_no_item": dense(
            ("kDdSpreadPieces = 33;", "kDdSpreadPieces = 1 << 30;")),
        # the rows copied with cp.async (16 bytes a lane, padded rows) at
        # every D, as at D 96, instead of TMA
        "ragged_decode/cp_async": dense((
            "static constexpr bool kTma = D % 64 == 0;",
            "static constexpr bool kTma = false;")),
    }


def paged_variant_shapes():
    """(label, kv_len, H, Kh, D) of the paged decode's variant timings:
    Qwen3-0.6B's serve shape and every paged family's heads at its serve
    lengths (as ``kernels_family_shapes``), and Gemma2-2B's (256, 2)."""
    return [
        ("serve_qwen3_0_6b_d128_g2", serve_decode_lens(), 16, 8, 128),
        ("qwen1_5_d128_g8", family_serve_lens(32, 64, 1024, 64, 22), 64, 8,
         128),
        ("nemotron_d192_g12", family_serve_lens(16, 64, 1024, 64, 21), 96, 8,
         192),
        ("granite_moe_d64_g3", family_serve_lens(32, 64, 1024, 64, 24), 24,
         8, 64),
        ("qwen3_moe_d128_g16", family_serve_lens(32, 64, 1024, 64, 25), 64,
         4, 128),
        ("phi3_vision_d96_g1", family_serve_lens(
            32, 64 + PHI3_PATCHES, 1024 + PHI3_PATCHES, 64, 26), 32, 32, 96),
        ("gemma2_d256_g2", family_serve_lens(16, 64, 1024, 64, 23), 8, 4,
         256),
    ]


def serve_decode_lens():
    """kv_len of the 32 slots of the decode kernels' serve shape."""
    import numpy as np
    rng = np.random.RandomState(11)
    return (rng.randint(64, 1025, size=32)
            + rng.randint(0, 129, size=32)).tolist()


def start_variant_builds(sources):
    """One nvcc per entry of ``sources`` (name -> (library, {file: text}),
    as ``variant_sources``), all started at once, each into its own
    directory under build/variants; name -> (library, dir, process)."""
    from repro_torch.kernels import build
    procs = {}
    for name, (lib, files) in sources.items():
        d = build.BUILD_DIR / "variants" / name.replace("/", "__")
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        procs[name] = (lib, d, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(d / "lib.so"), str(d / f"{lib}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish_variant_builds(procs):
    """Wait for ``start_variant_builds``' processes; name -> (library,
    loaded library, nvcc's log) of each that built (a failed build fails
    the run)."""
    import ctypes
    out = {}
    for name, (lib, d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            check(False, f"variant {name}: nvcc failed\n{log[-2000:]}")
            continue
        out[name] = (lib, ctypes.CDLL(str(d / "lib.so")), log)
    return out


def phase_variants(torch, dev):
    """Build every variant in parallel, then time each through its C
    entry point (no wrapper; ``ms`` with CUDA events back to back,
    ``kernel_ms`` the device time of its launches) on the serve shapes'
    inputs, with its max error against the plain version; at the paged
    decode's shapes on fp pages also the bound and the library call
    (gather + SDPA), cold; the fused head: ``fused_head_variants``."""
    import ctypes

    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    procs = start_variant_builds(variant_sources())
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, H, Kh, D = 8, 1024, 16, 8, 128
    q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, Kh, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, Kh, D), generator=g, device=dev).bfloat16()
    fa_want = ref.flash_attention_ref(q, k, v)
    fa_out = torch.empty_like(q)
    # the paged decode at the serve shape and every paged family's heads,
    # fp and int8 pages (with the slots' new rows)
    dec = {}
    for label, lens, H_, Kh_, D_ in paged_variant_shapes():
        dq, dkp, dvp, dbt, dkv = paged_inputs(torch, dev, torch.bfloat16,
                                              lens, H_, Kh_, D_)
        _, k8, v8, ks8, vs8, _, _ = int8_inputs(ref, (dq, dkp, dvp, dbt, dkv))
        kn, vn = (torch.randn((len(lens), Kh_, D_), generator=g,
                              device=dev).bfloat16() for _ in range(2))
        dec[f"{label}/fp"] = (dq, dkp, dvp, None, None, None, None, dbt, dkv,
                              1, ref.paged_decode_attention_ref(
                                  dq, dkp, dvp, dbt, dkv))
        if D_ != 256:                       # int8 pages: every shape but
            dec[f"{label}/int8"] = (                     # Gemma2's
                dq, k8, v8, ks8, vs8, kn, vn, dbt, dkv, 2,
                ref.paged_decode_attention_int8_ref(
                    dq, k8, v8, ks8, vs8, dbt, dkv, k_new=kn, v_new=vn))
    rows, fused, dense = {}, {}, {}
    for name, (lib, so, log) in finish_variant_builds(procs).items():
        if lib == "fused_sample":
            fused[name.split("/")[1]] = (so, log)
            continue
        if lib == "ragged_decode_attention":
            dense[name.split("/")[1]] = (so, log)
            continue
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
            calls[name] = (call, err, r"flash_wgmma_kernelILi128E")
        else:
            fn = so.paged_decode_attention
            fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            so.paged_decode_splits.argtypes = [ctypes.c_int] * 2
            so.paged_decode_workspace_floats.argtypes = [ctypes.c_int] * 4
            so.paged_decode_workspace_floats.restype = ctypes.c_longlong
            for key, (dq, kp_, vp_, ks_, vs_, kn_, vn_, dbt, dkv, code,
                      want) in dec.items():
                B_, H_, D_ = dq.shape
                Kh_, nb = kp_.shape[2], dbt.shape[1]
                G_ = H_ // Kh_
                ml, acc = build.split_scratch(so.paged_decode_splits(nb, 16),
                                              B_, H_, D_, dev)
                ws = torch.empty(max(so.paged_decode_workspace_floats(
                    D_, G_, Kh_, code), 1), device=dev)
                cnt = torch.zeros(B_ * Kh_, dtype=torch.int32, device=dev)
                out = torch.empty_like(dq)

                def call(a=(dq, kp_, vp_, ks_, vs_, kn_, vn_, dbt, dkv, out,
                            ml, acc, ws, cnt), sh=(B_, H_, Kh_, D_, 16, nb),
                         code=code):
                    return fn(*[build.data_ptr(t) for t in a], *sh, 0.0, 1,
                              code, stream)

                def err(out=out, want=want):
                    return float((out.float() - want.float()).abs().max())
                pat = (r"(paged_decode_hopper_kernelI"
                       + ("13__nv_bfloat16" if code == 1 else "a")
                       + rf"|decode_split_kernelI13__nv_bfloat16\w*)Li{D_}"
                       + rf"ELi{G_}E")
                calls[f"{name}/{key}"] = (call, err, pat)
        for row_name, (call, err, pat) in calls.items():
            rc = call()
            torch.cuda.synchronize()
            check(rc == 0, f"variant {row_name}: launch failed with {rc}")
            regs = ptxas_functions(log, pat)
            # the decode rows cold (each call after an L2 flush), as an
            # engine's layer reads its pool; the others back to back
            # (the hot ones' device time held to HELD_SHARE of their ms)
            cold = lib == "paged_decode_attention"
            ms = ((cuda_ms_cold(torch, call) if cold
                   else cuda_ms(torch, call)) if rc == 0 else None)
            rows[row_name] = {
                "rc": rc, "max_abs_err": err(), "ms": ms,
                "kernel_ms": (None if rc != 0
                              else device_ms(torch, call, cold=True)[0]
                              if cold else held_device_ms(
                                  torch, call, HELD_SHARE * ms,
                                  f"variant {row_name}")),
                "l2": "cold" if cold else "hot",
                "registers": max((v["registers"] or 0
                                  for v in regs.values()), default=None),
                "spill_bytes": sum(v["spill_bytes"] or 0
                                   for v in regs.values())}
    paged_shapes = {k: dict(B=v[0].shape[0], H=v[0].shape[1],
                            Kh=v[1].shape[2], D=v[0].shape[2], P=16,
                            live_rows=int(v[8].sum()), q="bfloat16")
                    for k, v in dec.items()}
    # fp pages: the bound (each live K/V row, q and out once) and the
    # library call (gather + SDPA with a key mask), cold, at each shape
    for key, (dq, kp_, vp_, _, _, _, _, dbt, dkv, code, _) in dec.items():
        if code != 1:
            continue
        B_, H_, D_ = dq.shape
        Kh_ = kp_.shape[2]
        G_, live = H_ // Kh_, int(dkv.sum())
        mask = (torch.arange(dbt.shape[1] * 16, device=dev)[None, :]
                < dkv[:, None])[:, None, None, :]

        def library(q=dq, kp=kp_, vp=vp_, bt=dbt, mask=mask, G=G_):
            k_ = ref.gather_pages(kp, bt).transpose(1, 2) \
                .repeat_interleave(G, 1)
            v_ = ref.gather_pages(vp, bt).transpose(1, 2) \
                .repeat_interleave(G, 1)
            return F.scaled_dot_product_attention(q[:, :, None], k_, v_,
                                                  attn_mask=mask)
        paged_shapes[key].update(
            library_ms=cuda_ms_cold(torch, library, reps=5),
            **bound(4 * dq.numel() + 4 * live * Kh_ * D_
                    + 4 * (dbt.numel() + dkv.numel()), 4 * live * H_ * D_))
    del q, k, v, fa_want, fa_out, dec
    torch.cuda.empty_cache()
    fused_rows = fused_head_variants(torch, dev, fused) if fused else []
    dense_rows = dense_decode_variants(torch, dev, dense) if dense else []
    emit({"phase": "variants",
          "shapes": {"flash_attention": dict(B=B, S=S, H=H, Kh=Kh, D=D),
                     "fused_sample": {r["head"]: r["shape"]
                                      for r in fused_rows},
                     "paged_decode": paged_shapes},
          "variants": rows, "fused_head": fused_rows,
          "dense_decode": dense_rows})


# (label, S, kv_len, H, Kh, D, softcap) of the dense decode's variant
# timings: the launch path's long_500k (Gemma2-2B's global layers) and
# decode_32k (Qwen3-0.6B), the dense serve shape, then Gemma2's ring and
# global caches, Whisper's self- and cross-attention, Phi-3-Vision's
# dense layout and Zamba2's left-padded slots (with kv_start; as
# ``kernels_family_shapes``); the design variants run at the first four,
# ``DENSE_EVERY_SHAPE`` at every one
DENSE_VARIANT_SHAPES = [
    ("long_500k_d256_g2", 524_800, [524_281], 8, 4, 256, 50.0),
    ("decode_32k_d128_g2", 33_280, [32_761] * 8, 16, 8, 128, 0.0),
    ("serve_d128_g2", 2048, None, 16, 8, 128, 0.0),
    ("gemma2_ring_d256_g2", 4096, "gemma2_ring", 8, 4, 256, 50.0),
    ("whisper_self_d64_g1", 448, "whisper_self", 12, 12, 64, 0.0),
    ("phi3_dense_d96_g1", 2048, "phi3_dense", 32, 32, 96, 0.0),
    ("gemma2_global_d256_g2", 8192, "gemma2_global", 8, 4, 256, 50.0),
    ("whisper_cross_d64_g1", 1500, [1500] * 32, 12, 12, 64, 0.0),
    ("zamba2_kv_start_d64_g1", 2048, "zamba2", 32, 32, 64, 0.0),
]
DENSE_EVERY_SHAPE = ("shipped", "shipped_again", "split_body")


def zamba2_serve_rows():
    """(kv_len, kv_start) of Zamba2-1.2B's 32 serve slots: prompts of
    64-1024 ids left-padded to the 1024 bucket plus up to 64 generated
    tokens and the new row; rows [kv_start, kv_len) live."""
    import numpy as np
    zr = np.random.RandomState(29)
    plen = zr.randint(64, 1025, size=32)
    gen = zr.randint(0, 65, size=32)
    return (1024 + gen + 1).tolist(), (1024 - plen).tolist()


def dense_variant_lens(key):
    """(kv_len, kv_start or None) of a ``DENSE_VARIANT_SHAPES`` entry, as
    the kernels phase gives its case."""
    g2 = family_serve_lens(16, 512, 6144, 64, 23)
    if key is None:
        return serve_decode_lens(), None
    if key == "gemma2_ring":
        return [min(n + 1, 4096) for n in g2], None
    if key == "gemma2_global":
        return [n + 1 for n in g2], None
    if key == "whisper_self":
        return [n + 1 for n in family_serve_lens(32, 16, 224, 64, 28)], None
    if key == "phi3_dense":
        return family_serve_lens(16, 64 + PHI3_PATCHES, 1024 + PHI3_PATCHES,
                                 64, 27), None
    if key == "zamba2":
        return zamba2_serve_rows()
    return key, None


def dense_decode_variants(torch, dev, builds, rounds=3):
    """The dense decode at ``DENSE_VARIANT_SHAPES`` through the C entries of
    ``builds`` (name -> (library, ptxas log)), cold (each call after an
    L2 flush, as an engine's layer reads its cache), interleaved:
    ``rounds`` rounds, each timing every variant once (``kernel_ms`` the
    device time of a call's launches, ``ms`` CUDA events); the medians,
    every round, and the last round's kernels a call (the split body's
    split and merge passes apart).  Every variant's result is held to the
    plain version by ``DECODE_RULE``."""
    import ctypes
    from repro_torch.kernels import build, ref
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for i, (label, S, key, H, Kh, D, cap) in enumerate(DENSE_VARIANT_SHAPES):
        lens, starts = dense_variant_lens(key)
        args = dense_inputs(torch, dev, torch.bfloat16, lens, S, H, Kh, D)
        q, kc, vc, kvl = args
        st = (None if starts is None else
              torch.tensor(starts, dtype=torch.int32, device=dev))
        B, G = len(lens), H // Kh
        want = ref.ragged_decode_attention_ref(*args, softcap=cap,
                                               kv_start=st)
        live = int((kvl.clamp(max=S) - (0 if st is None else st))
                   .clamp(min=0).sum())
        limit = bound(4 * q.numel() + 4 * live * Kh * D + 4 * B,
                      4 * live * H * D)
        calls, errs, regs = {}, {}, {}
        for name, (so, log) in builds.items():
            if i >= 4 and name not in DENSE_EVERY_SHAPE:
                continue
            fn = so.ragged_decode_attention
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            so.ragged_decode_splits.argtypes = [ctypes.c_int]
            so.ragged_decode_workspace_floats.argtypes = [ctypes.c_int] * 3
            so.ragged_decode_workspace_floats.restype = ctypes.c_longlong
            ml, acc = build.split_scratch(so.ragged_decode_splits(S), B, H,
                                          D, dev)
            ws = torch.empty(max(so.ragged_decode_workspace_floats(D, G, Kh),
                                 1), device=dev)
            cnt = torch.zeros(2 * B * Kh, dtype=torch.int32, device=dev)
            res = torch.empty_like(q)

            def call(fn=fn, t=(q, kc, vc, kvl, st, res, None, ml, acc, ws,
                                   cnt)):
                return fn(*[build.data_ptr(x) for x in t], B, H, S, Kh, D,
                          cap, 1, stream)
            rc = call()
            torch.cuda.synchronize()
            check(rc == 0, f"dense variant {name}/{label}: launch failed {rc}")
            if rc != 0:
                continue
            errs[name] = decode_excess(res, want)[0]
            check(errs[name] <= 0, f"dense variant {name}/{label}: "
                  f"{errs[name]:.3g} beyond {DECODE_RULE}")
            calls[name] = call
            fns = ptxas_functions(log, rf"(dense_decode_hopper_kernelI|decode_"
                                  rf"split_kernelI13__nv_bfloat16S\w*)Li{D}E"
                                  rf"Li{G}E")
            regs[name] = {"registers": max((v["registers"] or 0
                                            for v in fns.values()),
                                           default=None),
                          "spill_bytes": sum(v["spill_bytes"] or 0
                                             for v in fns.values())}
        times = {k: {"kernel_ms": [], "ms": []} for k in calls}
        per_call = {}
        for _ in range(rounds):
            for name, call in calls.items():
                times[name]["ms"].append(cuda_ms_cold(torch, call, reps=5))
                ms, per_call[name] = device_ms(torch, call, cold=True)
                times[name]["kernel_ms"].append(ms)
        row = {"shape_label": label, "card": card_name_and_power(),
               "shape": dict(B=B, S=S, H=H, Kh=Kh, D=D, softcap=cap,
                             live_rows=live, kv_start=st is not None),
               "rounds": rounds, "l2": "cold", **limit,
               "variants": {k: {"kernel_ms": statistics.median(v["kernel_ms"]),
                                "ms": statistics.median(v["ms"]),
                                "kernel_ms_all": v["kernel_ms"],
                                "kernels_per_call": per_call[k],
                                "excess": errs[k], **regs[k]}
                            for k, v in times.items()}}
        emit({"phase": "dense_decode_variants", **row})
        out.append(row)
        del args, q, kc, vc, kvl, st, want, calls
        torch.cuda.empty_cache()
    return out


# (label, B, Dm, V, tied) of the fused head's timings: Qwen3-0.6B's serve
# head and the five wide heads of the families (Nemotron at its 16 slots)
FUSED_HEADS = [("qwen3_0_6b_serve", 32, 1024, 151936, True),
               ("qwen3_moe", 32, 4096, 151936, False),
               ("phi3_vision", 32, 3072, 32064, False),
               ("granite_moe", 32, 1536, 49155, True),
               ("qwen1_5", 32, 8192, 152064, False),
               ("nemotron", 16, 18432, 256000, False)]


def fused_head_variants(torch, dev, builds, rounds=3):
    """The fused head at ``FUSED_HEADS`` (k 1), through the C entries of
    ``builds`` (name -> (library, ptxas log): ``shipped``,
    ``shipped_again``, ``mma_sync_design``) and the library call (matmul +
    topk + logsumexp), interleaved: ``rounds`` rounds, each timing every
    variant once (``kernel_ms`` the device time of a call's launches,
    ``ms`` CUDA events back to back, each device time held to the bound
    and, but the library call's, to ``HELD_SHARE`` of its ``ms`` by
    ``held_device_ms``); the medians and the spread.  The shipped build
    also runs its plan's alternatives: 4 and 6 stages.  Every variant's
    result is held to the plain version (values and lse within 1e-3,
    indices equal)."""
    import ctypes
    from repro_torch.kernels import fused_sample as fsm
    from repro_torch.kernels import ref
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(5)
    out = []
    for label, B, Dm, V, tied in FUSED_HEADS:
        w = (torch.randn((V, Dm) if tied else (Dm, V), generator=g,
                         device=dev) / math.sqrt(Dm)).bfloat16()
        w = w.T if tied else w
        x = torch.randn((B, Dm), generator=g, device=dev).bfloat16()
        want = ref.fused_sample_ref(x, w)
        p = fsm.plan(B, Dm, V, 1, fsm.sm_count(dev))
        ws, counter = fsm.workspace(dev, stream, p.ws_floats)
        calls = {}
        for name, (so, _) in builds.items():
            fn = so.fused_sample
            res = [torch.empty((B, 1), device=dev),
                   torch.empty((B, 1), dtype=torch.int32, device=dev),
                   torch.empty((B, 1), device=dev)]
            if name == "mma_sync_design":       # its C entry: 4 scratch tensors
                fn.argtypes = ([ctypes.c_void_p] * 2
                               + [ctypes.c_longlong] * 2
                               + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                               + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p])
                so.fused_sample_partials.argtypes = [ctypes.c_int] * 2
                npart = so.fused_sample_partials(V, 1)
                scratch = [torch.empty((B, npart), device=dev),
                           torch.empty((B, npart), device=dev),
                           torch.empty((B, npart, 1), device=dev),
                           torch.empty((B, npart, 1), dtype=torch.int32,
                                       device=dev)]

                def call(fn=fn, res=res, scratch=scratch):
                    return fn(x.data_ptr(), w.data_ptr(), w.stride(0),
                              w.stride(1),
                              *[t.data_ptr() for t in res + scratch], B, Dm,
                              V, 1, 0.0, 1, stream)
                calls[name] = (call, res, None)
                continue
            fn.argtypes = fsm._bind().fused_sample.argtypes
            plans = {name: p}
            if name == "shipped":
                for st in (4, 6):
                    if st != p.stages and fsm.head_smem_bytes(
                            p.n, 1, st) <= fsm.SMEM_MAX:
                        plans[f"shipped_{st}_stages"] = dataclasses.replace(
                            p, stages=st)
            for pname, pp in plans.items():
                pp = dataclasses.replace(pp, smem=fsm.head_smem_bytes(
                    pp.n, 1, pp.stages))
                r = [torch.empty_like(t) for t in res]

                def call(fn=fn, r=r, pp=pp):
                    return fn(x.data_ptr(), w.data_ptr(), w.stride(0),
                              w.stride(1), *[t.data_ptr() for t in r],
                              ws.data_ptr(), ws.numel(), counter.data_ptr(),
                              B, Dm, V, 1, 0.0, 1, pp.n, pp.stages,
                              pp.grid, pp.smem, stream)
                calls[pname] = (call, r, pp)

        def library():
            logits = torch.matmul(x, w).float()
            return torch.topk(logits, 1), torch.logsumexp(logits, -1)
        times = {k: {"kernel_ms": [], "ms": []} for k in calls}
        times["library"] = {"kernel_ms": [], "ms": []}
        errs = {}
        for name, (call, res, _) in calls.items():
            rc = call()
            torch.cuda.synchronize()
            check(rc == 0, f"fused variant {name}/{label}: launch failed {rc}")
            errs[name] = max(float((res[0] - want[0]).abs().max()),
                             float((res[2] - want[2]).abs().max()))
            check(errs[name] <= 1e-3 and bool((res[1] == want[1]).all()),
                  f"fused variant {name}/{label}: err {errs[name]}")
        limit = bound(V * Dm * 2 + B * Dm * 2 + B * 3 * 4, 2 * B * Dm * V)
        for _ in range(rounds):
            for name, (call, _, _) in calls.items():
                ms = cuda_ms(torch, call)
                times[name]["ms"].append(ms)
                times[name]["kernel_ms"].append(held_device_ms(
                    torch, call, max(limit["bound_ms"], HELD_SHARE * ms),
                    f"fused variant {name}/{label}"))
            times["library"]["ms"].append(cuda_ms(torch, library, 5, 3))
            times["library"]["kernel_ms"].append(held_device_ms(
                torch, library, limit["bound_ms"], f"fused library/{label}"))
        row = {"head": label, "card": card_name_and_power(),
               "shape": dict(B=B, Dm=Dm, V=V, tied=tied, top_k=1),
               "plan": p.__dict__, "rounds": rounds, **limit,
               "variants": {k: {"kernel_ms": statistics.median(v["kernel_ms"]),
                                "ms": statistics.median(v["ms"]),
                                "kernel_ms_all": v["kernel_ms"],
                                "max_abs_err": errs.get(k),
                                "plan": (calls[k][2].__dict__
                                         if k in calls and calls[k][2]
                                         else None)}
                            for k, v in times.items()}}
        emit({"phase": "fused_head_variants", **row})
        out.append(row)
        del w, x, calls
        torch.cuda.empty_cache()
    return out


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
    host = sorted((r for r in prof.key_averages()
                   if r.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: -r.self_cpu_time_total)[:8]
    return {"wall_ms": wall, "device_ms": dev_ms,
            "device_busy_share": dev_ms / wall if dev_ms else "not measured",
            "kernel_launches": sum(r.count for r in rows),
            "top_kernels_ms": {r.key[:60]: r.self_device_time_total / 1e3
                               for r in top},
            "top_host_ops_ms": {r.key[:60]: r.self_cpu_time_total / 1e3
                                for r in host}}


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


def int8_pool_gb(engine):
    """GB of an int8 engine's pool, of its page scales, and of the same
    pages in bf16."""
    pool = sum(a.numel() * a.element_size() for a in engine.cache.values())
    scales = sum(a.numel() * a.element_size()
                 for a in engine.kv_scales.values())
    bf16_pool = sum(a.numel() for a in engine.cache.values()) * 2
    return {"int8": pool / 1e9, "scales": scales / 1e9,
            "bf16_same_pages": bf16_pool / 1e9}


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
    summ.update(cache_stats=st8, num_pages=q8.num_pages,
                pool_gb=int8_pool_gb(q8))
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

def stub_inputs(model, batch):
    """The engine's stub frontend inputs for ``batch`` rows (zero patch
    rows or frames; {} for a family without a stub frontend)."""
    from repro_torch.rollout.engine import stub_inputs as engine_stub
    return engine_stub(model.cfg, batch, model.device)


def score(torch, model, params, prompt, gen):
    """Per generated token: (argmax, logprob of the token, max logprob)
    from the plain full-sequence forward on prompt + generated tokens
    (behind the engine's zero stub rows or frames, where the family has
    a stub frontend)."""
    toks = torch.tensor([list(prompt) + [t for t, _ in gen]],
                        device=model.device)
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": toks,
                                           **stub_inputs(model, 1)})
    n = len(prompt) + model.prefill_extra
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


def f32_logprobs(torch, model, params, prompt, gen):
    """Logprobs of the generated tokens under the plain forward in f32 on
    the same (bf16) weights, each layer's weights cast to f32 only while
    it runs (a whole f32 copy of a large model would not fit beside it)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    f32 = torch.float32
    cfg = model.cfg.replace(param_dtype=f32, compute_dtype=f32)

    def cast(t):
        return {k: cast(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.float()
    toks = torch.tensor([list(prompt) + [t for t, _ in gen]],
                        device=model.device)
    extra = model.prefill_extra            # the vlm's zero patch rows
    pos = torch.arange(extra + toks.shape[1], device=toks.device)[None]
    with torch.no_grad():
        x = params["embed"][toks].float()
        x = torch.cat([x.new_zeros((1, extra, x.shape[2])), x], dim=1)
        for i in range(cfg.num_layers):
            x, _, _, _ = TF._block(
                cast(TF.layer(params, i, cfg)), cfg, x, pos,
                lambda q, k, v: L.full_attention(q, k, v, causal=True),
                TF.mlp_fn(cfg, with_aux=False))
        head = {"final_norm": cast(params["final_norm"])}
        head["embed" if cfg.tie_embeddings else "lm_head"] = (
            params["embed"] if cfg.tie_embeddings
            else params["lm_head"]).float()
        n = extra + len(prompt)
        logits = TF.lm_logits(head, cfg, x[0, n - 1:n - 1 + len(gen)])
    lp = torch.log_softmax(logits, -1)
    want = torch.tensor([t for t, _ in gen], device=lp.device)
    return lp.gather(1, want[:, None])[:, 0].tolist()


def against_f32(torch, model, params, served):
    """The served logprobs and the plain bf16 forward's, each against the
    plain forward in f32 on the same weights: max and mean |difference|
    (how far each bf16 path sits from the f32 one)."""
    eng, fwd = [], []
    for prompt, gen in served.values():
        want = f32_logprobs(torch, model, params, prompt, gen)
        _, lp, _ = score(torch, model, params, prompt, gen)
        eng += [abs(lt - w) for (_, lt), w in zip(gen, want)]
        fwd += [abs(l - w) for l, w in zip(lp, want)]
    return {"engine_max_abs": max(eng), "engine_mean_abs": statistics.mean(eng),
            "forward_bf16_max_abs": max(fwd),
            "forward_bf16_mean_abs": statistics.mean(fwd)}


def held_to_f32(f, int8=False):
    """The MoE families' logprob check (``against_f32``): the served
    logprobs within max(0.1 nats, the plain bf16 forward's own max
    distance) of the plain forward in f32 on the same weights, and in
    mean no farther than 1.25x the bf16 forward.  Routing makes the bf16
    forward itself a noisy reference: an expert set can change where two
    router probabilities nearly tie, moving a logprob by tenths of a nat
    (on an H100, the bf16 forward sat 0.157 nats from the f32 one at
    Qwen3-MoE's width), so the kernel path is held to the f32 forward
    with the bf16 path's own spread.  On int8 pages (``int8``) both
    limits take the int8 allowance (``INT8_ALLOWANCE_MAX``/``_MEAN``)."""
    tol_max = max(NEAR_TIE_BF16, f["forward_bf16_max_abs"])
    tol_mean = 1.25 * f["forward_bf16_mean_abs"]
    if int8:
        tol_max += INT8_ALLOWANCE_MAX
        tol_mean += INT8_ALLOWANCE_MEAN
    return dict(f, tol_max=tol_max, tol_mean=tol_mean,
                ok=f["engine_max_abs"] <= tol_max
                and f["engine_mean_abs"] <= tol_mean)


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


CARD_CPU_TOL = 0.05         # nats: an int8 engine on the card against CPU


class HeadRecord:
    """While installed on an engine with the fused greedy head, keeps the
    hidden row the head read for each (uid, step), so that the engine's
    logprob of any token at that step can be read after the run
    (``logprobs``): what an engine itself thought of a token that another
    run picked there.  Holds the engine's config and weights, not its
    pool."""

    def __init__(self, engine):
        from repro_torch.models import transformer as TF
        cfg, params_fn = engine.model.cfg, engine.params_fn
        self.head = lambda: TF.head_weight(params_fn(), cfg)
        self.softcap = cfg.logit_softcap
        self.calls = []
        slots, inner = engine.slots, engine._fused_greedy

        def fused(params, hidden):
            self.calls.append((hidden.detach().clone(), slots.uid.copy(),
                               slots.gen_count.copy(), slots.active.copy()))
            return inner(params, hidden)
        engine._fused_greedy = fused

    def logprobs(self, torch, uid, step, tokens):
        """The engine's logprobs of ``tokens`` at ``step`` of ``uid``: its
        head's logits in f32 from the kept row (the fused head's plain
        version, a vocabulary slice at a time)."""
        h = next(hid[i] for hid, uids, steps, act in self.calls
                 for i in range(len(uids))
                 if act[i] and uids[i] == uid and steps[i] == step).float()
        w = self.head()
        logits = torch.cat([h @ w[:, c:c + 16384].float()
                            for c in range(0, w.shape[1], 16384)])
        if self.softcap > 0:
            logits = torch.tanh(logits / self.softcap) * self.softcap
        lp = logits - torch.logsumexp(logits, -1)
        return [float(lp[t]) for t in tokens]


def streams_agree(torch, card, plain, card_heads, plain_heads,
                  tol=CARD_CPU_TOL, forward=None):
    """The same int8 engine's greedy streams through the card's kernels
    (``card``) and through the plain versions (``plain``: on CPU tensors,
    or on the card with ``PlainInt8Decode``): tokens equal up to a first
    divergence, and there only at a near-tie inside both engines: each
    engine's logprob of the other's token within ``tol`` of its logprob
    of its own pick (``HeadRecord``, the hidden row each head read at
    that step); logprobs before it within ``tol``.  Both attend in the
    same order, but the kernels sum in another order, which can tip a
    cell at an int8 rounding tie to the next step.  ``forward`` (model,
    params, prompts) also asks the plain fp forward to see the two tokens
    within ``tol`` (the e2e phase's rule before the engines' own)."""
    agree, diverged, bad, lp_gap, at = 0, 0, 0, 0.0, []
    for uid, want in plain.items():
        got = card[uid]
        n = next((i for i, (a, b) in enumerate(zip(want, got))
                  if a[0] != b[0]), None)
        same = len(want) if n is None else n
        lp_gap = max([lp_gap] + [abs(a[1] - b[1]) for a, b
                                 in zip(want[:same], got[:same])])
        if n is None:
            agree += len(want) == len(got)
            continue
        diverged += 1
        tc, tp = got[n][0], want[n][0]
        cc, cp = card_heads.logprobs(torch, uid, n, (tc, tp))
        pc, pp = plain_heads.logprobs(torch, uid, n, (tc, tp))
        d = {"uid": uid, "step": n, "card_token": tc, "plain_token": tp,
             "card_lps": [cc, cp], "plain_lps": [pp, pc],
             "card_lp_served": got[n][1], "plain_lp_served": want[n][1]}
        tie = cc - cp <= tol and pp - pc <= tol
        if forward is not None:
            model, params, prompts = forward
            _, lps, _ = score(torch, model, params, prompts[uid], got[:n + 1])
            _, lpw, _ = score(torch, model, params, prompts[uid],
                              want[:n + 1])
            d["forward_lps"] = [lps[n], lpw[n]]
            tie = tie and abs(lps[n] - lpw[n]) <= tol
        bad += not tie
        at.append(d)
    return {"requests": len(plain), "streams_equal": agree,
            "diverged_at_near_tie": diverged - bad, "beyond_near_tie": bad,
            "divergences": at, "max_logprob_gap": lp_gap, "tol": tol,
            "ok": agree + diverged == len(plain) and bad == 0
            and lp_gap <= tol}


class PlainInt8Decode:
    """While installed, the models' int8 paged decode runs its plain
    version (``paged_decode_attention_int8_ref``) on the tensors it is
    given, on the card too: the engine's own pool, scales, tables and new
    rows, quantised and requantised by the engine's code as in a kernel
    run.  Beside it the kernel is launched on the same inputs, and its
    output is compared with the plain version's at every call
    (``summary``: the max |difference|, and the excess over the bf16
    decode rule, ``decode_excess``).  The engine goes on with the plain
    version's output, so a run under it differs from a kernel run in the
    decode's rounding alone: the plain version rounds q/sqrt(D) to q's
    dtype, as the reference's oracle, the kernel keeps it in f32, as the
    Pallas body, and sums in another order.  The fp paged decode is left
    alone."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.ops, kernel = ops, ops.paged_decode_attention
        self.kernel = kernel
        self.calls, self.max_abs, self.excess, self.share = 0, 0.0, None, 0.0

        def decode(q, k_pages, v_pages, block_tables, kv_len, softcap=0.0,
                   window=0, k_scales=None, v_scales=None, k_new=None,
                   v_new=None):
            if k_scales is None:
                return kernel(q, k_pages, v_pages, block_tables, kv_len,
                              softcap=softcap, window=window)
            want = ref.paged_decode_attention_int8_ref(
                q, k_pages, v_pages, k_scales, v_scales, block_tables,
                kv_len, softcap=softcap, window=window, k_new=k_new,
                v_new=v_new)
            got = kernel(q, k_pages, v_pages, block_tables, kv_len,
                         softcap=softcap, window=window, k_scales=k_scales,
                         v_scales=v_scales, k_new=k_new, v_new=v_new)
            excess, share, _ = decode_excess(got, want)
            self.calls += 1
            self.max_abs = max(self.max_abs, float(
                (got.float() - want.float()).abs().max()))
            self.excess = excess if self.excess is None else max(
                self.excess, excess)
            self.share = max(self.share, share)
            return want
        ops.paged_decode_attention = decode
        return self

    def __exit__(self, *exc):
        self.ops.paged_decode_attention = self.kernel

    def summary(self, tol):
        return {"calls": self.calls, "max_abs_err": self.max_abs, "tol": tol,
                "excess_over_decode_rule": self.excess,
                "beyond_step_over_rms": self.share, "tol_rule": DECODE_RULE,
                "ok": self.calls > 0 and self.max_abs <= tol}


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
    outs, heads = {}, {}
    for name, opts in (("paged", {"fused_sampling": True}),
                       ("dense", {"paged": False}),
                       ("int8", {"kv_quant": "int8", "fused_sampling": True})):
        eng = SlotEngine(model, lambda: params, **kw, **opts)
        if name == "int8":
            heads["card"] = HeadRecord(eng)
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
    #   only at a near-tie of the fp forward (0.05 nats) and of both
    #   engines (``streams_agree``); logprobs before it within 0.05 nats.
    #   Both attend in the same order, but the card computes K/V and the
    #   attention in another f32 sum order, which can tip a cell at an
    #   int8 rounding tie to the next step, and over 24 steps of a 4-layer
    #   model such cells add up;
    # - against the fp forward: no farther than the CPU run of the same
    #   engine, plus those 0.05 nats.
    first = sum(outs["int8"][u][0][0] == g[0][0]
                for u, g in outs["paged"].items())
    check(first == len(reqs), f"e2e f32 int8: first token differs from fp "
          f"in {len(reqs) - first} of {len(reqs)} requests")
    cpu_eng = SlotEngine(build_model(cfg, device="cpu"),
                         lambda p=to_cpu(params): p, kv_quant="int8",
                         fused_sampling=True, **kw)
    heads["cpu"] = HeadRecord(cpu_eng)
    outs["int8_cpu"] = {}
    t0 = time.perf_counter()
    serve_loop(cpu_eng, list(reqs), outs["int8_cpu"], [])
    cpu_s = time.perf_counter() - t0
    del cpu_eng
    cmp = streams_agree(torch, outs["int8"], outs["int8_cpu"],
                        heads["card"], heads["cpu"],
                        forward=(model, params, prompts))
    agree, diverged = cmp["streams_equal"], cmp["diverged_at_near_tie"]
    lp_gap = cmp["max_logprob_gap"]
    check(cmp["ok"], f"e2e f32 int8 card vs CPU: {cmp}")
    del heads
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
    ``prompts``, from one plain forward (no kernels): (positions, d).  A
    vision-language model sees its zero patch rows first, as the engine
    serves it.  The recurrent families' forward runs with an identity
    head, whose logits are the normed hidden state (in bf16)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    cfg, dev = model.cfg, model.device
    lens = [len(p) for p in prompts]
    toks = torch.zeros((len(prompts), max(lens)), dtype=torch.long,
                       device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    extra = model.prefill_extra
    if model.padding_side == "left":
        eye = torch.eye(cfg.d_model, device=dev, dtype=cfg.compute_dtype)
        with torch.no_grad():
            h, _ = model.forward(dict(params, lm_head=eye), {"tokens": toks})
        return torch.cat([h[i, :n].float() for i, n in enumerate(lens)])

    def attend(q, k, v):
        return L.full_attention(q, k, v, causal=True)
    with torch.no_grad():
        x = TF.embed_tokens(params, cfg, toks)
        if extra:
            x = torch.cat([x.new_zeros((x.shape[0], extra, x.shape[2])), x],
                          dim=1)
        pos = torch.arange(x.shape[1], device=dev).expand(*x.shape[:2])
        for i in range(cfg.num_layers):
            x, _, _, _ = TF._block(TF.layer(params, i, cfg), cfg, x, pos,
                                   attend, TF.mlp_fn(cfg, with_aux=False))
        h = L.norm(x[:, extra:], params["final_norm"], cfg.norm_type,
                   cfg.norm_eps)
        return torch.cat([h[i, :n].float() for i, n in enumerate(lens)])


def set_eos_row(torch, model, params, prompts, eos=RL_EOS, logit=None):
    """EOS's (``eos``) row of the head (its embedding row when the head is
    tied, its ``lm_head`` column otherwise) along the mean of the final
    normed hidden state over ``prompts`` (one plain forward), scaled so
    that EOS's logit averages ``logit`` (``RL_EOS_LOGIT`` by default)
    there.  Returns what it measured."""
    logit = logit or RL_EOS_LOGIT
    h = final_hidden(torch, model, params, prompts)
    with torch.no_grad():
        mean = h.mean(0)
        u = mean / mean.norm()
        along = float((h @ u).mean())
        row = u * (logit / along)
        if model.cfg.tie_embeddings:
            params["embed"][eos] = row.to(params["embed"].dtype)
        else:
            params["lm_head"][:, eos] = row.to(params["lm_head"].dtype)
    return {"hidden_norm": float(h.norm(dim=-1).mean()),
            "mean_hidden_norm": float(mean.norm()),
            "eos_row_norm": float(row.norm()), "eos_logit_mean": logit}


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
        m, v, old = m[1].float(), v[1].float(), old.to(new.device)
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


# Granite-MoE's rl phase: EOS is an id of its own (not the pad id 0),
# the last of its 49,155
GRANITE_RL_EOS = 49154


def phase_rl(torch, dev, model, params, launches, label="rl", eos=RL_EOS,
             n_groups=16, update_batch=16, min_updates=3,
             state_dtype=None, max_total=384, eos_logit=None,
             gap_to_f32=False):
    """Qwen3-0.6B at full width and depth (bf16, the serve phase's random
    weights): the paged SlotEngine rolls out GRPO groups at temperature 1
    under the sorted policy in partial mode, and RLTrainer updates the
    weights the engine reads (PPO-clip, GRPO advantages, AdamW).

    An MoE model (Granite-MoE-3B-A800M) runs the same loop with its own
    EOS id, batch and update count.  Its engine and trainer route the
    same tokens in other batches, so their capacity drops differ (the
    reference's behaviour): the engine-against-trainer logprob gap is
    reported beside both sides' dropped shares, not held to 0.1 nats, and
    no f32 forward is taken.  Checked instead: every uid trained once,
    every update finite, the router and every expert leaf moved.

    Phi-3-Vision-4.2B runs it too, with a ``max_total`` that holds its
    576 patch rows: the engine serves every prompt behind zero patch rows
    and the trainer scores the same tokens without them (the reference's
    ``entries_to_batch`` builds no ``patch_embeds``), so that gap is
    reported, not held, as well.

    Zamba2-1.2B runs it on the dense layout (its rollouts left-padded,
    its update batches right-padded, as in the reference): the flash
    kernel 6 times a prefill wave and the dense decode kernel 6 times a
    step (the shared block's applications).  Its trainer's bf16 forward
    is itself ~0.2 nats from the f32 forward at random weights
    (``gap_to_f32``), so the engine is held to the f32 forward as the
    trainer's bf16 forward is: no farther than max(0.1, 1.25x the
    trainer's max) and 1.25x its mean, and no bias (|mean difference|
    <= 0.01); the 0.1-nat max against the trainer is reported.  The
    stitching checks of updates 2 on are the Qwen3 run's (``rl``), whose
    schedule (16 groups, batches of 16) was sized for them."""
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
    moe = cfg.family == "moe"
    held = cfg.family not in ("moe", "vlm")   # engine and trainer agree
    prompts, metas = rl_prompts(n_groups, 4, 64, 192, cfg.vocab_size, seed=6)
    eos_row = set_eos_row(torch, model, params, prompts[::4], eos,
                          eos_logit or RL_EOS_LOGIT)
    opt_cfg = AdamWConfig(lr=1e-5, state_dtype=state_dtype or torch.float32)
    trainer = RLTrainer(model, params, rl_reward, opt_cfg=opt_cfg, pad_id=0,
                        max_len=max_total, advantage_kind="grpo")
    engine = SlotEngine(model, trainer.params, capacity=32,
                        max_total_len=max_total, max_gen_len=128,
                        eos_id=eos, pad_id=0, temperature=1.0, seed=3,
                        kv_retain_across_sync=True)
    leaves = tree_leaves(trainer.params())
    ptrs = [t.data_ptr() for t in leaves]
    updates, first, step_ms, gen_lens, trained = [], {}, [], [], []
    drops = MoEDrops(torch)
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
            drops.label = "trainer_forward"
            logits, _ = model.forward(trainer.params(), batch)
            drops.label = None
            lp = token_logprobs(logits, batch["tokens"])[mask]
            del logits
            if not held:
                diff = lp - old[mask]
                return {"tokens": int(mask.sum()),
                        "max_abs": float(diff.abs().max()),
                        "mean_abs": float(diff.abs().mean()),
                        "mean": float(diff.mean()),
                        "held": False, "batch": list(batch["tokens"].shape),
                        "versions": sorted({v for e in req.entries
                                            for v in e.versions})}
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
            # a large model's copy waits on the host: beside the AdamW
            # state and the update's activations it would not fit
            before = [p.to("cpu", copy=True) if not held else p.clone()
                      for p in leaves]
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
        trained.extend(e.uid for e in req.entries)
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
    with drops:
        orch.run_group(prompts, metas)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches[label] = counts
    rollout = {k: n - train_launches[k] for k, n in counts.items()}
    rollout_s = wall - host_s["train"] - host_s["check"]
    tokens = sum(u["trained_tokens"] for u in updates)

    check(len(updates) >= min_updates,
          f"{label}: {len(updates)} updates, want >= {min_updates}")
    check(sorted(trained) == sorted(set(trained))
          and len(trained) == len(prompts),
          f"{label}: {len(trained)} trained entries, {len(set(trained))} "
          f"uids, {len(prompts)} prompts")
    for i, u in enumerate(updates, 1):
        check(all(math.isfinite(v) for v in u.values()
                  if isinstance(v, float)),
              f"{label}: update {i} not finite {u}")
        check(u["grad_norm"] > 0, f"{label}: update {i}: grad_norm 0")
        if i > 1 and label == "rl":
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
    check(lp.get("versions") == [0], f"{label}: first batch versions {lp}")
    if held and gap_to_f32:
        tol_f32_max = max(0.1, 1.25 * lp.get("trainer_vs_f32_max_abs", 0.0))
        check(abs(lp.get("mean", 1.0)) <= 0.01
              and lp.get("engine_vs_f32_mean_abs", 1.0)
              <= 1.25 * lp.get("trainer_vs_f32_mean_abs", 0.0)
              and lp.get("engine_vs_f32_max_abs", 1.0) <= tol_f32_max,
              f"{label}: engine vs trainer logprobs {lp}")
        lp.update(tol_mean=0.01, tol_f32_ratio=1.25,
                  tol_f32_max_abs=tol_f32_max, max_abs_held=False)
    elif held:
        check(lp.get("max_abs", 1.0) <= 0.1
              and abs(lp.get("mean", 1.0)) <= 0.01
              and lp.get("engine_vs_f32_mean_abs", 1.0)
              <= 1.25 * lp.get("trainer_vs_f32_mean_abs", 0.0),
              f"rl: engine vs trainer logprobs {lp}")
        lp.update(tol_max_abs=0.1, tol_mean=0.01, tol_f32_ratio=1.25)
    else:
        check(math.isfinite(lp.get("max_abs", math.nan)),
              f"{label}: engine vs trainer logprobs {lp}")
    lv = first.get("leaves", {"bad": ["not run"]})
    check(not lv["bad"] and lv["moved"],
          f"{label}: leaves after the first update {lv}")
    if moe:
        want = [f"layers/mlp/{n}" for n in ("router", "w_gate", "w_in",
                                            "w_out")]
        check(all(w in lv["moved"] for w in want),
              f"{label}: router or experts did not move {lv}")
    decode = ("paged_decode_attention" if engine.paged
              else "ragged_decode_attention")
    na = attention_layers(cfg)
    check(rollout["flash_attention"] > 0 and rollout[decode] > 0,
          f"{label}: rollout launches {rollout}")
    check(not any(train_launches.values()),
          f"{label}: train steps launched kernels {train_launches}")
    check_launches(label, counts, {
        decode: na * decode_steps[0],
        "flash_attention": na * engine.prefill_launches})
    ms = sorted(u["step_ms"] for u in updates)
    emit({"phase": label, "model": cfg.name, "layers": nl,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "dtype": "bfloat16",
          "card": card_name_and_power(),
          "setup": {"capacity": 32, "max_total_len": max_total,
                    "max_gen_len": 128, "temperature": 1.0,
                    "policy": "sorted", "mode": "partial",
                    "rollout_batch": 32, "group_size": 2,
                    "update_batch": update_batch, "advantage": "grpo",
                    "lr": 1e-5,
                    "adamw_state": str(opt_cfg.state_dtype).split(".")[-1],
                    "prompts": len(prompts), "eos_id": eos,
                    "eos_row": eos_row},
          "moe_pairs": drops.summary() if moe else None,
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


def phase_rl_moe(torch, dev, launches):
    """Granite-MoE-3B-A800M at full width and depth through the rl phase's
    loop (``phase_rl``): 8 GRPO groups of 4, update batches of 8 and
    AdamW with bf16 moments (the reference's ``state_dtype`` option):
    weights, gradients and f32 moments (39 GB) beside the activations of
    8 x 320 tokens through 32 layers (f32 attention scores, the experts'
    buffers; about 40 GB) would not fit in 80 GB."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    model = build_model(get_config("granite_moe_3b_a800m"))
    params = model.init_params(torch.Generator(device=dev).manual_seed(1))
    phase_rl(torch, dev, model, params, launches, label="rl_moe",
             eos=GRANITE_RL_EOS, n_groups=8, update_batch=8, min_updates=2,
             state_dtype=torch.bfloat16)
    del model, params
    release(torch)


# Phi-3's <|end|>.  With its 32,064 ids, EOS's mean logit at RL_EOS_LOGIT
# (8.5) gave a mean length of 11 tokens on an H100, and at 7.0 still 30:
# EOS's logit varies widely between positions, and two GRPO groups of 4
# whose prompts end far above the mean answered EOS at once, so the
# first update batch held 8 one-token answers of one reward (no
# gradient).  5.0 makes such answers rarer.
PHI3_RL_EOS = 32007
PHI3_RL_EOS_LOGIT = 5.0


def phase_rl_vlm(torch, dev, launches):
    """Phi-3-Vision-4.2B at full width and depth through the rl phase's
    loop (``phase_rl``): 8 GRPO groups of 4, update batches of 8, AdamW
    with bf16 moments, and a ``max_total_len`` of 1024, which holds the
    576 patch rows, a prompt of up to 192 ids and 128 generated tokens.
    The engine serves each prompt behind zero patch rows and the trainer
    scores the tokens without them, as the reference does: the gap
    between the two is reported, not held."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    model = build_model(get_config("phi_3_vision_4_2b"))
    params = model.init_params(torch.Generator(device=dev).manual_seed(2))
    phase_rl(torch, dev, model, params, launches, label="rl_vlm",
             eos=PHI3_RL_EOS, n_groups=8, update_batch=8, min_updates=2,
             state_dtype=torch.bfloat16, max_total=1024,
             eos_logit=PHI3_RL_EOS_LOGIT)
    del model, params
    release(torch)


# Zamba2's EOS in the rl phase: an id of its own (not the pad id 0), the
# last of its 32,000; its mean logit that of Phi-3's EOS (a vocabulary of
# the same size, where 8.5 ended most answers within a few tokens)
ZAMBA2_RL_EOS = 31999
ZAMBA2_RL_EOS_LOGIT = PHI3_RL_EOS_LOGIT


def phase_rl_hybrid(torch, dev, launches):
    """Zamba2-1.2B at full width and depth (38 Mamba2 layers, the shared
    block 6 times) through the rl phase's loop (``phase_rl``) on the
    dense layout: 8 GRPO groups of 4, update batches of 8, AdamW with
    bf16 moments, 4 updates; the engine's logprobs held to the f32
    forward (``phase_rl``'s ``gap_to_f32``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    model = build_model(get_config("zamba2_1_2b"))
    params = model.init_params(torch.Generator(device=dev).manual_seed(3))
    phase_rl(torch, dev, model, params, launches, label="rl_hybrid",
             eos=ZAMBA2_RL_EOS, n_groups=8, update_batch=8, min_updates=4,
             state_dtype=torch.bfloat16, eos_logit=ZAMBA2_RL_EOS_LOGIT,
             gap_to_f32=True)
    del model, params
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
# The limit the families served on int8 pages are reported against: the
# bf16 limits plus the Qwen3-0.6B int8 path's own distance from the fp
# forward (the int8 engine at 4 layers in f32 sat 0.2200 nats (max) and
# 0.0451 (mean) from the f32 forward on an H100, the e2e line), stated
# before the first int8 run of the families (PERF.md's predictions).  Nemotron
# (0.366) and Qwen3-MoE (mean 0.073 against 0.071) came out past it, so it
# is reported, not held.  Held instead, beside the launches: at full
# width the kernel against its plain version at every call of a second
# run on the card (``int8_plain_witness``, 2e-2), and at 1 layer the
# same engine on CPU tensors (``int8_card_against_cpu``, 0.05 nats).
INT8_ALLOWANCE_MAX, INT8_ALLOWANCE_MEAN = 0.22, 0.045
NEAR_TIE_INT8 = NEAR_TIE_BF16 + INT8_ALLOWANCE_MAX


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
# Phase 7: the rest of the dense family at full width
# ---------------------------------------------------------------------------

# label -> (arch, layers served (None: all), engine options, slots,
# max_total_len, prompt lengths of the GRPO groups of 4 (None: drawn from
# 64-1024), uids of the 3 requests held against the plain forward,
# factors on the residual updates' output projections: attention's "wo"
# and the MLP's "w_out"); max_gen_len 64, greedy, random weights, no EOS
# (eos_id -1).
# Gemma2's scaled, tied embedding dominates the residual stream at the
# init scale: its own row then wins the tied head at the 30-nat softcap
# and every greedy logprob reads 0.0 in both the engine and the forward,
# which holds nothing (at 4x the init scale, still -0.0027 in mean on an
# H100).  Output projections (wo, w_out) at 8x their init scale
# put the residual updates ~4x the embedding's norm and the self logit
# near 12 nats, below the logsumexp of the other 256k (~13).
# Phi-3-Vision at the init scale: random q and k spread a long context's
# attention over ~1000 keys (576 of them zero patch rows), so its output
# is a near-uniform average of random values and the check cannot see
# it: on an H100 the last layer's attention output zeroed moved the
# served logprobs by 0.109 nats where the bf16 noise alone was 0.103
# (paged) and 0.095 against 0.094 (dense).  Its attention output
# projections (wo) at 4x their init scale give attention a share of the
# residual updates like the MLPs'.
FAMILIES = {
    # a prompt past the 4096 window, and the 8192 bucket holding shorter
    # rows (the reference's ring-prefill fault would show on them)
    "gemma2": ("gemma2_2b", None, {"paged": False}, 16, 8192,
               [6144, 4500, 1800, 512], (0, 8, 12),
               {"wo": 8.0, "w_out": 8.0}),
    "qwen1_5": ("qwen1_5_110b", 4, {"fused_sampling": True}, 32, 2048,
                None, (0, 4, 8), {}),
    "nemotron": ("nemotron_4_340b", 2, {"fused_sampling": True}, 16, 2048,
                 None, (0, 4, 8), {}),
    # the same on int8 KV pages (D 192, G 12)
    "nemotron_int8": ("nemotron_4_340b", 2, {"fused_sampling": True,
                                             "kv_quant": "int8"}, 16, 2048,
                      None, (0, 4, 8), {}),
    # 576 zero patch rows before every prompt (the engine's stub inputs)
    "phi3_vision": ("phi_3_vision_4_2b", None, {"fused_sampling": True}, 32,
                    2048, None, (0, 4, 8), {"wo": 4.0}),
    "phi3_vision_dense": ("phi_3_vision_4_2b", None, {"paged": False}, 16,
                          2048, None, (0, 4, 8), {"wo": 4.0}),
    # paged on int8 KV pages (D 96, G 1: rows padded to 8 chunks in the
    # kernel's shared memory)
    "phi3_vision_int8": ("phi_3_vision_4_2b", None,
                         {"fused_sampling": True, "kv_quant": "int8"}, 32,
                         2048, None, (0, 4, 8), {"wo": 4.0}),
    # 1500 zero frames through the encoder; 448 is Whisper's decoder
    # context
    "whisper": ("whisper_small", None, {}, 32, 448, range(16, 225),
                (0, 4, 8), {}),
    # the left-padded recurrent families on the dense layout: prompts of
    # 64-1024 ids right-aligned in the 1024 bucket
    "zamba2": ("zamba2_1_2b", None, {"paged": False}, 32, 2048, None,
               (0, 4, 8), {}),
    "xlstm": ("xlstm_125m", None, {"paged": False}, 32, 2048, None,
              (0, 4, 8), {}),
}
FAMILY_GEN = 64


def family_requests(lens, n_groups, vocab, seed):
    """GRPO groups of 4 sharing a prompt: of the given lengths (a list),
    of lengths drawn from a range, or from 64-1024 (None)."""
    import numpy as np
    from repro_torch.core.buffer import BufferEntry
    if lens is None or isinstance(lens, range):
        lo, hi = (64, 1024) if lens is None else (lens.start, lens.stop - 1)
        return make_requests(n_groups, 4, lo, hi, vocab, seed)
    rng = np.random.RandomState(seed)
    out = []
    for gi, n in enumerate(lens):
        prompt = rng.randint(1, vocab, size=n).tolist()
        out += [BufferEntry(uid=4 * gi + j, prompt=list(prompt))
                for j in range(4)]
    return out


def attention_layers(cfg):
    """Attention layers one pass through the model runs: the hybrid's
    shared block once per group, none in xLSTM, every layer otherwise."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return 0 if cfg.family == "ssm" else cfg.num_layers


def attention_outputs(params, cfg):
    """(name, tensor) of the parts whose zeroing the 0.1-nat check must
    see (views): the last layer's attention output projection (whisper's
    self- and cross-attention), the hybrid's shared block's, and xLSTM's
    last sLSTM block's output projection."""
    from repro_torch.models import transformer as TF
    nl = cfg.num_layers
    if cfg.family == "hybrid":
        return [("the shared attention block's output projection",
                 params["shared_attn"]["attn"]["wo"])]
    if cfg.family == "ssm":
        return [("the last sLSTM block's output projection",
                 params["slstm"]["proj"][nl // 2 - 1])]
    if cfg.family == "audio":
        dec = params["dec_layers"]
        return [(f"layer {nl - 1}'s self-attention output",
                 dec["attn"]["wo"][nl - 1]),
                (f"layer {nl - 1}'s cross-attention output",
                 dec["xattn"]["wo"][nl - 1])]
    return [(f"layer {nl - 1}'s attention output",
             TF.layer(params, nl - 1, cfg)["attn"]["wo"])]


def ablated_checks(torch, label, model, params, check_fn,
                   tol=NEAR_TIE_BF16, base=None):
    """The check's power: ``check_fn()`` (a near-tie record at ``tol``)
    again with each part of ``attention_outputs`` zeroed (what the engine
    would serve from kernels returning zeros there) must fail it, and be
    farther off than the unablated record ``base`` (which an int8 run may
    show past ``tol``: reported, not held)."""
    out = []
    for name, wo in attention_outputs(params, model.cfg):
        saved = wo.clone()
        wo.zero_()
        ablated = check_fn()
        wo.copy_(saved)
        del saved
        ablated["ablation"] = f"{name} zeroed"
        base_err = base["max_logprob_err"] if base else 0.0
        base_flips = base["flips_beyond_tol"] if base else 0
        ablated["detected"] = (
            ablated["max_logprob_err"] > max(tol, base_err)
            or ablated["flips_beyond_tol"] > base_flips)
        check(ablated["detected"], f"families/{label}: the {tol}-nat check "
              f"does not see {name} zeroed {ablated}")
        out.append(ablated)
    return out


def prefill_patches_check(torch, model, params, launches):
    """Random patch rows (0.1 N(0, 1), as the reference's model tests)
    through the engine's prefill on the card (flash over 576 + 1024 rows)
    against the plain forward on each row's patch rows and prompt: at
    every position of a row (patch rows and tokens), the logprob of the
    forward's argmax within 0.1 nats and the argmax equal but at
    near-ties; and the same comparison against the forward with the last
    layer's attention output zeroed must fail.  Zero patch rows stay zero
    through every layer (no bias, norm of 0 is 0), so the served path
    tests only their dilution of the softmax; these test the kernels over
    rows that are not zero."""
    import numpy as np
    from repro_torch.kernels import ops
    cfg = model.cfg
    P = cfg.num_stub_positions
    lens = [1024, 700, 333, 64]
    rng = np.random.RandomState(51)
    toks = torch.zeros((len(lens), max(lens)), dtype=torch.int32,
                       device=model.device)
    for i, n in enumerate(lens):
        toks[i, :n] = torch.tensor(rng.randint(1, cfg.vocab_size, size=n),
                                   device=toks.device)
    g = torch.Generator(device=toks.device).manual_seed(52)
    patches = (0.1 * torch.randn((len(lens), P, cfg.d_model), generator=g,
                                 device=toks.device)).to(cfg.compute_dtype)
    batch = {"tokens": toks, "patch_embeds": patches,
             "prompt_lens": torch.tensor(lens, dtype=torch.int32,
                                         device=toks.device)}
    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        logits, _ = model.prefill(params, batch,
                                  model.init_cache(len(lens), P + max(lens)))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        counts = ops.launch_counts()
        launches["families/prefill_patches"] = counts
        check_launches("families/prefill_patches", counts,
                       {"flash_attention": cfg.num_layers})
        served = torch.log_softmax(logits.float(), -1)
        del logits

        def compare():
            err, total, flips, bad, n = 0.0, 0.0, 0, 0, 0
            for i, m in enumerate(lens):
                fwd, _ = model.forward(params, {
                    "tokens": toks[i:i + 1, :m],
                    "patch_embeds": patches[i:i + 1]})
                want = torch.log_softmax(fwd[0].float(), -1)
                got = served[i, :P + m]
                best = want.argmax(-1)
                d = (got.gather(1, best[:, None])
                     - want.gather(1, best[:, None])).abs()
                err = max(err, float(d.max()))
                total += float(d.sum())
                n += P + m
                other = got.argmax(-1) != best
                flips += int(other.sum())
                gap = (want.max(-1).values
                       - want.gather(1, got.argmax(-1)[:, None])[:, 0])
                bad += int((other & (gap > NEAR_TIE_BF16)).sum())
                del fwd, want
            return {"requests": len(lens), "tokens": n, "argmax_flips": flips,
                    "flips_beyond_tol": bad, "max_logprob_err": err,
                    "mean_logprob_err": total / n, "tol": NEAR_TIE_BF16}
        tie = compare()
        check(tie["max_logprob_err"] <= NEAR_TIE_BF16
              and tie["flips_beyond_tol"] == 0,
              f"families/prefill_patches: {tie}")
        ablated = ablated_checks(torch, "prefill_patches", model, params,
                                 compare)
    del served
    return {"prompt_lens": lens, "patch_rows": P, "patch_scale": 0.1,
            "prefill_s": prefill_s, "launches": counts,
            "against_forward": tie, "against_ablated_forward": ablated}


def whisper_prefill_parts(torch, model, params, B=32, S=256):
    """Device time (CUDA events) of a Whisper prefill wave of B rows at
    width S with zero frames, and of its plain parts: the encoder (12
    layers of bidirectional attention over 1500 frames), the cross K/V
    projections and the decoder's 12 cross-attentions (B x S queries
    over 1500 rows), which the reference computes outside any kernel."""
    from repro_torch.models import layers as L
    from repro_torch.models import whisper as WH
    cfg, dev = model.cfg, model.device
    frames = stub_inputs(model, B)["frames"]
    toks = torch.randint(1, cfg.vocab_size, (B, S), device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks, "frames": frames,
             "prompt_lens": torch.full((B,), S, dtype=torch.int32,
                                       device=dev)}
    cache = model.init_cache(B, S)
    with torch.no_grad():
        enc = WH.encode(params, cfg, frames)
        kx, vx = WH.cross_kv(params, cfg, enc)
        qx = torch.randn((B, S, cfg.num_heads, cfg.resolved_head_dim),
                         device=dev).to(cfg.compute_dtype)
        out = {
            "wave": {"B": B, "S": S, "frames": cfg.encoder_positions},
            "prefill_ms": cuda_ms(torch, lambda: model.prefill(
                params, batch, cache, return_logits=False), 3, 1),
            "encoder_ms": cuda_ms(torch, lambda: WH.encode(params, cfg,
                                                           frames), 3, 1),
            "cross_kv_ms": cuda_ms(torch, lambda: WH.cross_kv(params, cfg,
                                                              enc), 3, 1),
            "cross_attention_ms_all_layers": cfg.num_layers * cuda_ms(
                torch, lambda: L.full_attention(qx, kx[0], vx[0],
                                                causal=False), 3, 1)}
    del enc, kx, vx, qx, cache
    return out


def recurrent_against_f32(torch, model, params, served):
    """The served logprobs and the plain bf16 forward's, each against the
    plain forward in f32 on the same weights (a recurrent model's whole
    f32 copy fits beside it), held as ``held_to_f32`` holds the MoE
    families; and the served tokens against the f32 forward's argmax:
    flips where its best token leads the served one by more than the
    logprob tolerance ``tol_max``.  xLSTM reports it; Zamba2 is held to
    it (``phase_families``)."""
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import tree_map
    f32 = torch.float32
    m32 = build_model(model.cfg.replace(param_dtype=f32, compute_dtype=f32),
                      device=model.device)
    p32 = tree_map(lambda t: t.float(), params)
    eng, fwd, gaps = [], [], []
    for prompt, gen in served.values():
        am, want, mx = score(torch, m32, p32, prompt, gen)
        _, lp, _ = score(torch, model, params, prompt, gen)
        eng += [abs(lt - w) for (_, lt), w in zip(gen, want)]
        fwd += [abs(lt - w) for lt, w in zip(lp, want)]
        gaps += [m - w for a, m, w, (t, _) in zip(am, mx, want, gen)
                 if a != t]
    del p32
    held = held_to_f32({
        "engine_max_abs": max(eng), "engine_mean_abs": statistics.mean(eng),
        "forward_bf16_max_abs": max(fwd),
        "forward_bf16_mean_abs": statistics.mean(fwd)})
    held.update(tokens=len(eng), argmax_flips=len(gaps),
                flips_beyond_tol=sum(g > held["tol_max"] for g in gaps))
    return held


def timed_submits(torch, engine):
    """Wraps ``engine.submit`` so each call (the prefill wave with its
    host work) is timed between synchronisations; returns the list the
    times (ms) go to."""
    wave_ms, submit = [], engine.submit

    def timed(entries, version):
        torch.cuda.synchronize()
        t = time.perf_counter()
        submit(entries, version)
        torch.cuda.synchronize()
        wave_ms.append(1e3 * (time.perf_counter() - t))
    engine.submit = timed
    return wave_ms


def perturb_pad_biases(torch, params, cfg, seed):
    """Adds 0.3 N(0, 1) from a seeded generator to the biases the
    reference's left-padded prefill leaks through: Zamba2's conv biases
    (both, every Mamba2 layer), xLSTM's input layernorm biases (both
    blocks) and sLSTM gate biases.  Returns the tensors' old values."""
    g = torch.Generator(device=params["embed"].device).manual_seed(seed)
    if cfg.family == "hybrid":
        leaves = [params[k][b] for k in ("mamba_main", "mamba_tail")
                  if k in params for b in ("conv_x_b", "conv_bc_b")]
    else:
        leaves = [params["mlstm"]["ln"]["bias"], params["slstm"]["ln"]["bias"],
                  params["slstm"]["b_gates"]]
    saved = [(t, t.clone()) for t in leaves]
    for t in leaves:
        t.add_((0.3 * torch.randn(t.shape, generator=g, device=t.device)
                ).to(t.dtype))
    return saved


def pad_exact_check(torch, label, model, params, launches):
    """Left-padded prefill made exact, on the card: with the pad-leaking
    biases perturbed (``perturb_pad_biases``), 4 requests of 1000, 700,
    333 and 64 ids served in one dense wave (width 1024: 24 to 960 pad
    columns) and 16 greedy tokens each, held to the plain forward on the
    same weights within 0.1 nats (tokens equal but at near-ties)."""
    from repro_torch.kernels import ops
    from repro_torch.rollout.engine import SlotEngine
    cfg = model.cfg
    saved = perturb_pad_biases(torch, params, cfg, seed=61)
    reqs = family_requests([1000, 700, 333, 64], 4, cfg.vocab_size, seed=62)
    reqs = reqs[::4]                       # one request per prompt
    prompts = {e.uid: list(e.prompt) for e in reqs}
    engine = SlotEngine(model, lambda: params, capacity=4,
                        max_total_len=2048, max_gen_len=16, eos_id=-1,
                        temperature=0.0, paged=False)
    outputs, summ = run_path(torch, ops, engine, reqs)
    launches[f"families/{label}_pad_exact"] = summ["launches"]
    na = attention_layers(cfg)
    check_launches(f"families/{label}_pad_exact", summ["launches"], {
        "flash_attention": na * engine.prefill_launches,
        "ragged_decode_attention": na * summ["steps"]})
    check(engine.prefill_launches == 1,
          f"families/{label}_pad_exact: {engine.prefill_launches} waves")
    del engine
    tie = near_tie_check(torch, model, params,
                         {u: (prompts[u], outputs[u]) for u in prompts},
                         NEAR_TIE_BF16)
    check(tie["max_logprob_err"] <= NEAR_TIE_BF16
          and tie["flips_beyond_tol"] == 0,
          f"families/{label}_pad_exact: {tie}")
    for t, old in saved:
        t.copy_(old)
    return {"prompt_lens": [len(p) for p in prompts.values()], "width": 1024,
            "biases_perturbed": "0.3 N(0, 1), seed 61",
            "against_forward": tie, "launches": summ["launches"]}


# The int8 families' card-against-CPU check runs 1 layer at the family's
# published (H, Kh, D) and d_model on the CPU's plain versions; what the
# CPU's time needs is cut further: d_ff (or the experts' d_ff), the
# vocabulary, and Qwen3-MoE's experts to as many as a token takes (8: all
# taken by every token, at cf 1.0 no drop, and no expert choice for the
# card's and the CPU's sum orders to tip).
INT8_CPU_CUTS = {
    "nemotron_4_340b": {"d_ff": 1024, "vocab_size": 4096},
    "phi_3_vision_4_2b": {"d_ff": 1024, "vocab_size": 4096},
    "qwen3_moe_235b_a22b": {"vocab_size": 4096, "moe": {
        "d_ff_expert": 256, "capacity_factor": 1.0}},
}


def int8_card_against_cpu(torch, dev, arch, opts, label):
    """The int8 gate of ROADMAP section 2 at a family's heads: the same
    int8 engine (``opts``) on the card and on CPU tensors (the plain
    versions), at 1 layer of the published (H, Kh, D) and d_model with
    ``INT8_CPU_CUTS``, random bf16 weights from a seed, 3 requests of
    64-256 ids, 16 greedy steps, compared by ``streams_agree``
    (0.05 nats)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.rollout.engine import SlotEngine
    full = get_config(arch)
    cut = dict(INT8_CPU_CUTS[arch])
    if "moe" in cut:
        cut["moe"] = dataclasses.replace(
            full.moe, num_experts=full.moe.experts_per_token, **cut["moe"])
    cfg = full.replace(num_layers=1, **cut)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(5))
    reqs = make_requests(3, 1, 64, 256, cfg.vocab_size, seed=47)
    prompts = {e.uid: list(e.prompt) for e in reqs}
    kw = dict(capacity=4, max_total_len=1024, max_gen_len=16, eos_id=-1,
              temperature=0.0, **opts)
    card, cpu = {}, {}
    ops.reset_launch_counts()
    eng = SlotEngine(model, lambda: params, **kw)
    card_heads = HeadRecord(eng)
    serve_loop(eng, list(reqs), card, [])
    torch.cuda.synchronize()
    n_int8 = ops.launch_counts()["paged_decode_attention_int8"]
    check(n_int8 > 0, f"families/{label}: the 1-layer card run launched no "
          "int8 decode")
    eng = SlotEngine(build_model(cfg, device="cpu"),
                     lambda p=to_cpu(params): p, **kw)
    cpu_heads = HeadRecord(eng)
    t0 = time.perf_counter()
    serve_loop(eng, list(reqs), cpu, [])
    cpu_s = time.perf_counter() - t0
    del eng
    cmp = streams_agree(torch, card, cpu, card_heads, cpu_heads)
    check(cmp["ok"] and all(len(v) == 16 for v in card.values()),
          f"families/{label}: int8 card against CPU {cmp}")
    cmp.update(layers=1, d_model=cfg.d_model,
               heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
               head_dim=cfg.resolved_head_dim, vocab=cfg.vocab_size,
               cuts={k: (dataclasses.asdict(v) if k == "moe" else v)
                     for k, v in cut.items()},
               int8_decode_launches=n_int8, cpu_seconds=cpu_s,
               prompt_lens=sorted(len(p) for p in prompts.values()))
    del model, params
    release(torch)
    return cmp


INT8_TOL = 2e-2     # the int8 kernel cases' bf16 tolerance (phase_kernels)


def int8_plain_witness(torch, path, make_engine, reqs, served, heads):
    """The same engine (``make_engine``) serving the same requests on the
    card with its int8 decode through the plain version, the kernel
    launched beside it at every call (``PlainInt8Decode``): at full
    width, on pages the engine quantised itself, the kernel's output
    within ``INT8_TOL`` of the plain version's at every call (held).  The
    served int8 run (``served``, its ``HeadRecord`` ``heads``) against
    the plain run's streams by ``streams_agree`` (0.05 nats) is
    reported: over 32 layers, or where a router's top-k flips at a
    near-tie, the two decodes' roundings move a logprob past it (PERF.md
    section 6)."""
    engine = make_engine()
    plain_heads, plain = HeadRecord(engine), {}
    with PlainInt8Decode() as shadow:
        serve_loop(engine, list(reqs), plain, [])
    del engine
    per_call = shadow.summary(INT8_TOL)
    check(per_call["ok"], f"{path}: the int8 kernel against its plain "
          f"version on the engine's own pages {per_call}")
    streams = streams_agree(torch, served, plain, heads, plain_heads)
    streams.update(held=False, within_stated_limit=streams.pop("ok"))
    release(torch)
    return {"per_call": per_call, "streams": streams}


def phase_families(torch, dev, launches):
    """Gemma2-2B at full width and depth (26 layers: local/global, rings of
    4096, softcaps; the dense layout), Qwen1.5-110B at full width cut to 4
    layers and Nemotron-4-340B at full width cut to 2 (paged, fused greedy
    head), Phi-3-Vision-4.2B at full width and depth (32 layers, 576 zero
    patch rows before every prompt; paged with the fused head, then the
    dense layout), Whisper-small at full width and depth (12 + 12
    layers, 1500 zero frames; the dense layout, plain head), and the
    left-padded recurrent families on the dense layout with the plain
    head: Zamba2-1.2B (38 Mamba2 layers, the shared block 6 times) and
    xLSTM-125M (12 blocks), one after another, each freed before the
    next: every request served, exactly its path's kernels launched (6
    flash a wave and 6 dense decodes a step for Zamba2, none for xLSTM),
    3 requests' logprobs within 0.1 nats of the port's plain forward
    (tokens equal but at near-ties; Zamba2's held to the f32 forward by
    ``recurrent_against_f32``), and beyond that of the forward with the
    last layer's attention output (for Whisper each of its two; Zamba2's
    shared block's, xLSTM's last sLSTM projection) zeroed; each prefill
    wave timed.  The recurrent families also serve with their
    pad-leaking biases perturbed (``pad_exact_check``).  Phi-3-Vision's
    prefill is also held to the forward on random patch rows
    (``prefill_patches``), and Whisper's prefill wave is timed in
    parts.  Nemotron and Phi-3-Vision also serve on int8 KV pages (the
    int8 decode launched in place of the fp one; the kernel held to its
    plain version at every call of a second run on the card,
    ``int8_plain_witness``; the gap to the forward reported against
    ``NEAR_TIE_INT8``, the zeroed part seen, and the same engine at 1
    layer on the card against CPU tensors, ``int8_card_against_cpu``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.rollout.engine import SlotEngine

    models = {}
    for label, (arch, layers, opts, slots, max_len, lens, held, scale) in \
            FAMILIES.items():
        full = get_config(arch)
        cfg = full if layers is None else full.replace(num_layers=layers)
        t0 = time.perf_counter()
        model = build_model(cfg)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        for leaf, factor in scale.items():
            params["layers"]["attn" if leaf == "wo" else "mlp"][leaf].mul_(
                factor)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_groups = len(lens) if isinstance(lens, list) else slots // 4
        reqs = family_requests(lens, n_groups, cfg.vocab_size, seed=41)
        prompts = {e.uid: list(e.prompt) for e in reqs}

        def make_engine():
            return SlotEngine(model, lambda: params, capacity=slots,
                              max_total_len=max_len, max_gen_len=FAMILY_GEN,
                              eos_id=-1, temperature=0.0, **opts)
        engine = make_engine()
        int8 = engine.kv_quant == "int8"
        heads = HeadRecord(engine) if int8 else None
        wave_ms = timed_submits(torch, engine)
        outputs, summ = run_path(torch, ops, engine, reqs)
        summ["prefill_wave_ms"] = wave_ms
        launches[f"families/{label}"] = summ["launches"]
        check_answers(f"families/{label}", outputs, len(reqs), cfg.vocab_size)
        nl, na = cfg.num_layers, attention_layers(cfg)
        tol = NEAR_TIE_INT8 if int8 else NEAR_TIE_BF16
        want = {"flash_attention": na * engine.prefill_launches}
        if engine.paged:
            want.update({"paged_decode_attention_int8" if int8 else
                         "paged_decode_attention": na * summ["steps"],
                         "fused_sample": summ["steps"]})
        else:              # whisper: a self- and a cross-attention a layer
            want["ragged_decode_attention"] = (
                (2 if cfg.family == "audio" else 1) * na * summ["steps"])
        if int8:
            summ.update(num_pages=engine.num_pages,
                        pool_gb=int8_pool_gb(engine))
        check_launches(f"families/{label}", summ["launches"], want)
        check(all(len(v) == FAMILY_GEN for v in outputs.values()),
              f"families/{label}: a request stopped short of {FAMILY_GEN}")
        del engine
        release(torch)
        if int8:
            summ["against_plain_int8"] = int8_plain_witness(
                torch, f"families/{label}", make_engine, reqs, outputs, heads)
            del heads
        served = {u: (prompts[u], outputs[u]) for u in held}
        tie = near_tie_check(torch, model, params, served, tol)
        tie["prompt_lens"] = [len(prompts[u]) for u in held]
        if cfg.family == "hybrid":
            # Zamba2's bf16 forward is itself ~0.3 nats from its f32
            # forward at random weights (PERF.md section 4): the served
            # logprobs and tokens are held to the f32 forward instead
            tie["held"] = False
            f32_held = recurrent_against_f32(torch, model, params, served)
            check(f32_held["ok"] and f32_held["flips_beyond_tol"] == 0,
                  f"families/{label}: against the f32 forward {f32_held}")
            summ["against_f32"] = f32_held
            ablated = []
            for name, wo in attention_outputs(params, cfg):
                saved = wo.clone()
                wo.zero_()
                a = recurrent_against_f32(torch, model, params, served)
                wo.copy_(saved)
                del saved
                a["ablation"] = f"{name} zeroed"
                a["detected"] = not a["ok"] or a["flips_beyond_tol"] > 0
                check(a["detected"], f"families/{label}: the f32 check "
                      f"does not see {name} zeroed {a}")
                ablated.append(a)
        else:
            within = (tie["max_logprob_err"] <= tol
                      and tie["flips_beyond_tol"] == 0)
            if int8:
                # the int8 limit, stated before the first run (PERF.md's
                # predictions), is reported against: held are the launches,
                # the plain int8 decode's run, the card against CPU tensors
                # and the ablation's power
                tie.update(held=False, within_stated_limit=within)
            else:
                check(tie["max_logprob_err"] <= tol,
                      f"families/{label}: logprob err "
                      f"{tie['max_logprob_err']}")
                check(tie["flips_beyond_tol"] == 0,
                      f"families/{label}: {tie['flips_beyond_tol']} tokens "
                      f"differ beyond a near-tie of {tol}")
            ablated = ablated_checks(
                torch, label, model, params,
                lambda: near_tie_check(torch, model, params, served, tol),
                tol, tie)
        lp_mean = statistics.mean(lp for v in outputs.values()
                                  for _, lp in v)
        check(lp_mean < -1e-3, f"families/{label}: greedy logprobs all ~0 "
              f"(mean {lp_mean}): a one-hot head holds nothing")
        summ.update(
            arch=arch, layers=nl, layers_published=full.num_layers,
            depth="full" if layers is None else
            f"cut to {nl} of {full.num_layers} layers",
            d_model=cfg.d_model, head_dim=cfg.resolved_head_dim,
            heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
            vocab=cfg.vocab_size, layout="paged" if opts.get(
                "fused_sampling") else "dense", kv_quant=opts.get("kv_quant"),
            slots=slots, max_total_len=max_len, max_gen_len=FAMILY_GEN,
            prompt_lens=sorted({len(p) for p in prompts.values()}),
            stub_rows=cfg.num_stub_positions, prefill_extra=model.prefill_extra,
            params_gb=sum(t.numel() * t.element_size()
                          for _, t in leaf_paths(params)) / 1e9,
            init_s=init_s, output_projection_scale=scale or None,
            greedy_logprob_mean=lp_mean,
            against_forward=tie, against_ablated_forward=ablated)
        if cfg.family == "audio":
            summ["encoder_layers"] = cfg.encoder_layers
            summ["prefill_parts"] = whisper_prefill_parts(torch, model,
                                                          params)
        if model.padding_side == "left":
            summ["attention_layers"] = na
            if cfg.family == "ssm":          # reported
                summ["against_f32"] = recurrent_against_f32(
                    torch, model, params, served)
            summ["pad_exact"] = pad_exact_check(torch, label, model, params,
                                                launches)
        if int8:
            del model, params
            release(torch)
            summ["card_against_cpu"] = int8_card_against_cpu(
                torch, dev, arch, opts, label)
        models[label] = summ
        if label == "phi3_vision":
            models["prefill_patches"] = prefill_patches_check(
                torch, model, params, launches)
        if not int8:
            del model, params
        del outputs
        release(torch)
    models.update(families_moe(torch, dev, launches))
    emit({"phase": "families", "dtype": "bfloat16",
          "weights": "random, from a seed", "models": models})


class MoEDrops:
    """While installed, counts the (token, expert) pairs of every MoE call
    and the dropped ones, on the card (no synchronisation per call), by
    kind: ``decode`` (one token a row), ``prefill`` (the engine's waves,
    and any no-grad forward), ``train`` (under autograd), or ``label``
    where one is set."""

    def __init__(self, torch):
        from repro_torch.models import moe as MOE
        self.torch, self.MOE = torch, MOE
        self.kind = self.label = None
        self.pairs, self.dropped = {}, {}

    def __enter__(self):
        MOE = self.MOE
        self._mlp, self._disp = MOE.moe_mlp_dense, MOE._dispatch_indices

        def mlp(p, cfg, x, with_aux=True):
            self.kind = "decode" if x.shape[1] == 1 else (
                "train" if self.torch.is_grad_enabled() else "prefill")
            return self._mlp(p, cfg, x, with_aux=with_aux)

        def disp(idx, E, C):
            pos, keep = self._disp(idx, E, C)
            k = self.label or self.kind
            self.pairs[k] = self.pairs.get(k, 0) + keep.numel()
            d = (~keep).sum()
            self.dropped[k] = self.dropped[k] + d if k in self.dropped else d
            return pos, keep
        MOE.moe_mlp_dense, MOE._dispatch_indices = mlp, disp
        return self

    def __exit__(self, *exc):
        self.MOE.moe_mlp_dense = self._mlp
        self.MOE._dispatch_indices = self._disp

    def summary(self):
        return {k: {"pairs": n, "dropped": int(self.dropped[k]),
                    "dropped_share": int(self.dropped[k]) / n}
                for k, n in self.pairs.items()}


# (arch, layers (None: the full depth), slots, max_total_len, held uids,
# the no-drop run's requests (None: the served ones again; else n groups
# of 1, prompt lengths lo-hi) and its held uids, engine options beside
# the fused head)
MOE_FAMILIES = {
    "granite_moe": ("granite_moe_3b_a800m", None, 32, 2048, (0, 4, 8),
                    None, (0, 4, 8), {}),
    # at C = T a 32 x 1024 wave's (E, C, d) buffer alone is 34 GB: the
    # no-drop run serves 8 requests of at most 512 ids
    "qwen3_moe": ("qwen3_moe_235b_a22b", 4, 32, 2048, (0, 4, 8),
                  (8, 64, 512), (0, 3, 6), {}),
    # the same on int8 KV pages (D 128, G 16)
    "qwen3_moe_int8": ("qwen3_moe_235b_a22b", 4, 32, 2048, (0, 4, 8),
                       (8, 64, 512), (0, 3, 6), {"kv_quant": "int8"}),
}


def families_moe(torch, dev, launches):
    """Granite-MoE-3B-A800M at full width and depth (32 layers) and
    Qwen3-MoE-235B-A22B at full width cut to 4 of 94 layers, paged with
    the fused greedy head, random weights, one after the other.  The run
    at the published capacity factor (1.25) is the one served and timed:
    every request answered, exactly its kernels' launches, the dropped
    share of (token, expert) pairs in decode and prefill, and its gap to
    the plain forward (each request alone: other drops), reported.  Then
    the same weights at capacity factor E / k (C >= T at every T, so no
    token's output depends on its batch): 3 requests' tokens equal to
    the plain forward's but at 0.1-nat near-ties, their logprobs held to
    the plain forward in f32 (``held_to_f32``), and the check must fail
    against the forward with the last layer's attention output zeroed.
    An int8 entry's two runs are each witnessed by a second run with its
    int8 decode through the plain version (``int8_plain_witness``),
    and its gaps to the forward are reported against the int8 allowance
    (``held_to_f32(..., int8=True)``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as TF
    from repro_torch.models.model import build_model
    from repro_torch.rollout.engine import SlotEngine

    models = {}
    for label, (arch, layers, slots, max_len, held, nodrop, nd_held,
                opts) in MOE_FAMILIES.items():
        full = get_config(arch)
        cfg = full if layers is None else full.replace(num_layers=layers)
        m, nl = cfg.moe, cfg.num_layers
        t0 = time.perf_counter()
        model = build_model(cfg)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        result = {}
        int8 = opts.get("kv_quant") == "int8"
        tol = NEAR_TIE_INT8 if int8 else NEAR_TIE_BF16
        nd_cfg = cfg.replace(moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.experts_per_token))
        for run, run_cfg in (("published", cfg), ("no_drop", nd_cfg)):
            run_model = build_model(run_cfg)
            path = f"families/{label}" + ("" if run == "published"
                                          else "_no_drop")
            reqs = family_requests(None, slots // 4, cfg.vocab_size, seed=41)
            if run == "no_drop" and nodrop is not None:
                reqs = make_requests(nodrop[0], 1, nodrop[1], nodrop[2],
                                     cfg.vocab_size, seed=43)
            prompts = {e.uid: list(e.prompt) for e in reqs}

            def make_engine(run_model=run_model):
                return SlotEngine(run_model, lambda: params, capacity=slots,
                                  max_total_len=max_len,
                                  max_gen_len=FAMILY_GEN, eos_id=-1,
                                  temperature=0.0, fused_sampling=True,
                                  **opts)
            engine = make_engine()
            heads = HeadRecord(engine) if int8 else None
            with MoEDrops(torch) as drops:
                outputs, summ = run_path(torch, ops, engine, reqs)
            launches[path] = summ["launches"]
            check_answers(path, outputs, len(reqs), cfg.vocab_size)
            check_launches(path, summ["launches"], {
                "flash_attention": nl * engine.prefill_launches,
                "paged_decode_attention_int8" if int8 else
                "paged_decode_attention": nl * summ["steps"],
                "fused_sample": summ["steps"]})
            if int8:
                summ.update(num_pages=engine.num_pages,
                            pool_gb=int8_pool_gb(engine))
            check(all(len(v) == FAMILY_GEN for v in outputs.values()),
                  f"{path}: a request stopped short of {FAMILY_GEN}")
            dropped = drops.summary()
            check(dropped.get("decode", {}).get("pairs") ==
                  nl * summ["steps"] * slots * m.experts_per_token,
                  f"{path}: decode routed other than every slot {dropped}")
            if run == "no_drop":
                check(all(v["dropped"] == 0 for v in dropped.values()),
                      f"{path}: pairs dropped at C >= T {dropped}")
            del engine
            release(torch)
            if int8:
                summ["against_plain_int8"] = int8_plain_witness(
                    torch, path, make_engine, reqs, outputs, heads)
                del heads
            uids = held if run == "published" else nd_held
            served = {u: (prompts[u], outputs[u]) for u in uids}
            tie = near_tie_check(torch, run_model, params, served, tol)
            tie["prompt_lens"] = [len(prompts[u]) for u in uids]
            summ.update(capacity_factor=run_cfg.moe.capacity_factor,
                        prompt_lens=sorted({len(p) for p in
                                            prompts.values()}),
                        moe_pairs=dropped, against_forward=tie,
                        greedy_logprob_mean=statistics.mean(
                            lp for v in outputs.values() for _, lp in v))
            check(summ["greedy_logprob_mean"] < -1e-3,
                  f"{path}: greedy logprobs all ~0: a one-hot head holds "
                  "nothing")
            if run == "no_drop":
                # tokens against the bf16 forward but at near-ties, the
                # logprobs against the f32 forward (held_to_f32)
                held = held_to_f32(against_f32(torch, run_model, params,
                                               served), int8)
                if int8:         # reported against, as phase_families
                    tie["within_stated_limit"] = tie["flips_beyond_tol"] == 0
                    held["held"] = False
                else:
                    check(tie["flips_beyond_tol"] == 0,
                          f"{path}: {tie['flips_beyond_tol']} tokens differ "
                          f"beyond a near-tie of {tol}")
                    check(held["ok"], f"{path}: logprobs against the f32 "
                          f"forward {held}")
                summ["against_f32_forward"] = held
                wo = TF.layer(params, nl - 1, cfg)["attn"]["wo"]
                saved = wo.clone()
                wo.zero_()
                ablated = near_tie_check(torch, run_model, params, served,
                                         tol)
                ablated["against_f32_forward"] = held_to_f32(against_f32(
                    torch, run_model, params, served), int8)
                wo.copy_(saved)
                del saved
                ablated["ablation"] = f"layer {nl - 1}'s attention output " \
                    "zeroed"
                a32 = ablated["against_f32_forward"]
                ablated["detected"] = (
                    a32["engine_max_abs"] > max(held["tol_max"],
                                                held["engine_max_abs"])
                    or a32["engine_mean_abs"] > max(held["tol_mean"],
                                                    held["engine_mean_abs"])
                    or ablated["flips_beyond_tol"] > tie["flips_beyond_tol"])
                check(ablated["detected"], f"{path}: the check does not see "
                      f"the last layer's attention zeroed {ablated}")
                summ["against_ablated_forward"] = ablated
            else:
                summ["against_forward"]["held"] = False
            result[run] = summ
            del outputs, run_model
            release(torch)
        models[label] = dict(
            arch=arch, layers=nl, layers_published=full.num_layers,
            depth="full" if layers is None else
            f"cut to {nl} of {full.num_layers} layers",
            d_model=cfg.d_model, head_dim=cfg.resolved_head_dim,
            heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
            experts=f"{m.num_experts} top-{m.experts_per_token}, "
                    f"d_ff {m.d_ff_expert}",
            vocab=cfg.vocab_size, tied=cfg.tie_embeddings, layout="paged",
            kv_quant=opts.get("kv_quant"),
            slots=slots, max_total_len=max_len, max_gen_len=FAMILY_GEN,
            params_gb=sum(t.numel() * t.element_size()
                          for _, t in leaf_paths(params)) / 1e9,
            init_s=init_s, **result)
        del model, params
        release(torch)
        if int8:
            models[label]["card_against_cpu"] = int8_card_against_cpu(
                torch, dev, arch, dict(opts, fused_sampling=True), label)
    return models


def moe_layer_check(torch, dev):
    """The reference's capacity-drop MoE layer on the card against the
    same layer on the CPU: Granite-MoE-3B-A800M's width (d 1536, 40
    experts top-8, d_ff 512) at its published capacity factor 1.25, f32
    with TF32 off, one random layer from a seed, at T = 32 (a decode step
    of 32 slots: C = 8) and T = 4 x 256 (a prefill wave: C = 256).
    Routing (idx), capacity drops (keep) equal; the output within 1e-4 of
    the CPU's largest |y| (max |card - cpu| <= 1e-4 * max |cpu|)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as MOE
    cfg = get_config("granite_moe_3b_a800m").replace(
        param_dtype=torch.float32, compute_dtype=torch.float32)
    p_cpu = MOE.init_moe_mlp(torch.Generator().manual_seed(5), cfg,
                             torch.float32, "cpu")
    p_gpu = {k: v.to(dev) for k, v in p_cpu.items()}
    m = cfg.moe
    rows = []
    for B, S in ((32, 1), (4, 256)):
        x = torch.randn((B, S, cfg.d_model),
                        generator=torch.Generator().manual_seed(B * S))
        T = B * S
        C = MOE._capacity(cfg, T)
        got, want = [], []
        for p, xx, out in ((p_gpu, x.to(dev), got), (p_cpu, x, want)):
            with torch.no_grad():
                _, idx, _ = MOE._route(p, cfg, xx.reshape(T, -1), False)
                _, keep = MOE._dispatch_indices(idx, m.num_experts, C)
                y, aux = MOE.moe_mlp_dense(p, cfg, xx)
            out += [idx.cpu(), keep.cpu(), y.cpu(),
                    {k: float(v) for k, v in aux.items()}]
        err = float((got[2] - want[2]).abs().max())
        scale = float(want[2].abs().max())
        row = {"T": T, "B": B, "S": S, "capacity": C,
               "pairs": int(keep.numel()),
               "dropped_cpu": int((~want[1]).sum()),
               "dropped_card": int((~got[1]).sum()),
               "idx_equal": bool(torch.equal(got[0], want[0])),
               "keep_equal": bool(torch.equal(got[1], want[1])),
               "max_abs_err": err, "max_abs_cpu": scale,
               "rel_err": err / scale, "aux_card": got[3], "aux_cpu": want[3]}
        check(row["idx_equal"] and row["keep_equal"],
              f"moe_layer T={T}: routing or drops differ from the CPU {row}")
        check(row["rel_err"] <= 1e-4, f"moe_layer T={T}: {row}")
        rows.append(row)
    emit({"phase": "moe_layer", "model": cfg.name, "dtype": "float32",
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "capacity_factor": m.capacity_factor, "tol_rel": 1e-4,
          "cases": rows})


# moe_ep: the expert-parallel layer against the dense one on the NCCL
# (1, 1) mesh, where the two are the same arithmetic.  The layer: y within
# 1e-4 of the largest |y| and the aux within 1e-6 (moe_layer's rule, f32,
# TF32 off); the placed steps over it (``mesh``'s Granite train and
# prefill, beside their bit-equality): loss and grad norm within
# LAUNCH_STEP_TOL, every parameter and cache leaf within one bf16
# rounding of its largest value (2^-7 relative), prefill tokens equal.
MOE_EP_TOL = {"y_rel": 1e-4, "aux_abs": 1e-6, "bf16_rel": 2.0 ** -7}
# one MoE layer's specs as Granite's plans place them (its 40 experts
# whole on ``model``, FSDP over ``data``)
MOE_EP_SPECS = {"router": (None, None), "w_in": (None, "data", None),
                "w_gate": (None, "data", None), "w_out": (None, None, "data")}


class DispatchRecord:
    """While installed, keeps (idx, keep) of every ``_dispatch_indices``
    call of ``repro_torch.models.moe``."""

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.MOE, real = MOE, MOE._dispatch_indices
        self.real, self.calls = real, []

        def recorded(idx, E, C, *args):
            pos, keep = real(idx, E, C, *args)
            self.calls.append((idx.cpu(), keep.cpu()))
            return pos, keep
        MOE._dispatch_indices = recorded
        return self

    def __exit__(self, *exc):
        self.MOE._dispatch_indices = self.real


def leaf_gap(torch, want, got):
    """max |got - want| over a leaf, and that over max |want|."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err, err / scale if scale else err


def moe_ep_layer(torch, dev, mesh):
    """``moe_mlp_ep`` on ``mesh`` against ``moe_mlp_dense`` at
    Granite-MoE-3B-A800M's width (d 1536, 40 experts top-8, cf 1.25), f32,
    one random layer from a seed, at moe_layer's T = 32 and 4 x 256: idx
    and keep equal, y and aux within ``MOE_EP_TOL``; each call timed
    (CUDA events) and profiled once (``profile_call``).  The layer runs
    under the placement a placed step installs (``MOE_EP_SPECS``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import collectives as COL
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import moe as MOE
    cfg = get_config("granite_moe_3b_a800m").replace(
        param_dtype=torch.float32, compute_dtype=torch.float32)
    p = MOE.init_moe_mlp(torch.Generator(device=dev).manual_seed(5), cfg,
                         torch.float32, dev)
    placement = SH.Placement(batch_axes=("data",),
                             params={"layers": {"mlp": MOE_EP_SPECS}})

    def ep(x):
        with SH.axis_rules(mesh, SH.train_rules(), placement):
            return MOE.moe_mlp_ep(p, cfg, x, mesh)
    rows = []
    for B, S in ((32, 1), (4, 256)):
        x = torch.randn((B, S, cfg.d_model),
                        generator=torch.Generator().manual_seed(B * S)).to(dev)
        a2a = COL.CALLS["all_to_all_single"]
        with torch.no_grad(), DispatchRecord() as rec:
            y_ep, aux_ep = ep(x)
            y, aux = MOE.moe_mlp_dense(p, cfg, x)
        exchanges = COL.CALLS["all_to_all_single"] - a2a
        (idx_ep, keep_ep), (idx, keep) = rec.calls
        err, rel = leaf_gap(torch, y, y_ep)
        aux_err = max(abs(float(aux_ep[k]) - float(aux[k])) for k in aux)
        with torch.no_grad():
            ep_ms = cuda_ms(torch, lambda: ep(x))
            dense_ms = cuda_ms(torch, lambda: MOE.moe_mlp_dense(p, cfg, x))
            profiles = {
                "ep": profile_call(torch, lambda: ep(x)),
                "dense": profile_call(torch, lambda: MOE.moe_mlp_dense(
                    p, cfg, x))}
        row = {"T": B * S, "B": B, "S": S,
               "capacity": MOE._capacity(cfg, B * S),
               "dropped": int((~keep).sum()), "pairs": int(keep.numel()),
               "idx_equal": bool(torch.equal(idx_ep, idx)),
               "keep_equal": bool(torch.equal(keep_ep, keep)),
               "max_abs_err": err, "rel_err": rel, "aux_abs_err": aux_err,
               "aux_ep": {k: float(v) for k, v in aux_ep.items()},
               "all_to_all_single": exchanges,
               "ep_ms": ep_ms, "dense_ms": dense_ms, "profile": profiles}
        check(row["idx_equal"] and row["keep_equal"],
              f"moe_ep layer T={B * S}: routing or drops differ {row}")
        check(rel <= MOE_EP_TOL["y_rel"] and aux_err <= MOE_EP_TOL["aux_abs"],
              f"moe_ep layer T={B * S}: {row}")
        check(exchanges == 2, f"moe_ep layer T={B * S}: {exchanges} "
              "all_to_all_single calls, not 2")
        rows.append(row)
    return rows


def phase_moe_ep(torch, dev, launches):
    """The expert-parallel MoE on the card: an NCCL world of one through a
    ``FileStore`` in a temporary directory (no network), the (1, 1)
    ``("data", "model")`` mesh on ``cuda``, then ``moe_ep_layer``; the
    group destroyed at the end."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_compat_mesh
    tmp = tempfile.mkdtemp(prefix="moe_ep_")
    store = dist.FileStore(str(Path(tmp) / "store"), 1)
    cuda = dev.type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo", store=store, rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120),
                            device_id=dev if cuda else None)
    try:
        mesh = make_compat_mesh((1, 1), ("data", "model"), dev.type)
        layer = moe_ep_layer(torch, dev, mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "moe_ep", "card": card_name_and_power(),
          "backend": dist.Backend.NCCL if cuda else dist.Backend.GLOO,
          "mesh": [1, 1], "tol": MOE_EP_TOL, "layer": layer})


# ---------------------------------------------------------------------------
# The placed launch steps on an NCCL world of one
# ---------------------------------------------------------------------------

MESH_DEPTH = 4
MOE_MESH_DEPTH = 8
# label -> (arch, shape, S, B, layers): the MoE family's placed steps
# (Granite-MoE-3B-A800M's train_4k at B 4 of 256, its 4 microbatches of
# one row, prefill_32k at 1 of 32 and its seqshard decode_32k at 8 of
# 128, at MOE_MESH_DEPTH of 32 layers; Qwen3-MoE-235B-A22B's decode_2d at
# 8 of 128 and 4 of 94 layers, 19.3 GB of experts), Qwen3-0.6B's plans
# at PERF.md section 4's cut batches (train_4k 2 rows, prefill_32k 1,
# decode_32k 8); the placed serve steps of Gemma2-2B's local/global cache
# (decode_32k at B 8 of 128, long_500k at its B 1) and of decode_2d
# (Qwen1.5-110B and Nemotron-4-340B at decode_32k, B 8 of 128); full
# widths, depth cut to MESH_DEPTH layers (Nemotron to 2: 32.7 GB of bf16
# weights, run twice)
MESH_RUNS = {
    "granite_train_4k": ("granite_moe_3b_a800m", "train_4k", 4096, 4,
                         MOE_MESH_DEPTH),
    "granite_prefill_32k": ("granite_moe_3b_a800m", "prefill_32k", 32_768,
                            1, MOE_MESH_DEPTH),
    "granite_decode_32k": ("granite_moe_3b_a800m", "decode_32k", 32_768, 8,
                           MOE_MESH_DEPTH),
    "qwen3_moe_decode_2d": ("qwen3_moe_235b_a22b", "decode_32k", 32_768, 8,
                            MESH_DEPTH),
    "train_4k": ("qwen3_0_6b", "train_4k", 4096, 2, MESH_DEPTH),
    "prefill_32k": ("qwen3_0_6b", "prefill_32k", 32_768, 1, MESH_DEPTH),
    "decode_32k": ("qwen3_0_6b", "decode_32k", 32_768, 8, MESH_DEPTH),
    "gemma2_decode_32k": ("gemma2_2b", "decode_32k", 32_768, 8, MESH_DEPTH),
    "gemma2_long_500k": ("gemma2_2b", "long_500k", 524_288, 1, MESH_DEPTH),
    "qwen1_5_decode_2d": ("qwen1_5_110b", "decode_32k", 32_768, 8,
                          MESH_DEPTH),
    "nemotron_decode_2d": ("nemotron_4_340b", "decode_32k", 32_768, 8, 2),
}
MESH_SERVE_STEPS = 4


def mesh_step_run(torch, dev, cfg, arch, shape_name, S, B, mesh):
    """One ``MESH_RUNS`` step on ``mesh``: built there, its inputs from
    seeds (placed by the step's ``in_shardings`` where it has them), the
    launch counts zeroed just before the run and read just after; the
    results gathered back to whole trees."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives as COL
    from repro_torch.kernels import ops
    from repro_torch.launch import plans, steps, train
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                             tree_leaves)
    plan = plans.get_plan(arch, shape_name)
    kind = kind_of(shape_name)
    a2a = COL.CALLS["all_to_all_single"]
    built = steps.build_step(cfg, ShapeConfig(shape_name, S, B, kind), plan,
                             mesh, False, device=dev)
    sh = built.in_shardings or (None,) * 4

    def place(tree, spec):
        return tree if spec is None else plans.place(tree, spec, mesh)

    def whole(tree, spec):
        return tree if spec is None else plans.gather(tree, spec, mesh)
    params = built.model.init_params(torch.Generator(device=dev)
                                     .manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {"placed": built.in_shardings is not None}
    if kind == "train":
        opt = init_opt_state(params, AdamWConfig(state_dtype=plan.opt_dtype))
        batch = train.make_batch(cfg, B, S, dev,
                                 torch.Generator().manual_seed(1))
        params, opt, batch = (place(params, sh[0]), place(opt, sh[1]),
                              place(batch, sh[2]))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        losses, gnorms, ms = [], [], []
        for _ in range(LAUNCH_STEPS):
            (params, opt, m), t = timed_call(torch, built.fn, params, opt,
                                             batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            ms.append(t)
        out.update(counts=ops.launch_counts(), loss=losses, grad_norm=gnorms,
                   ms=ms, leaves=tree_leaves(whole(params, sh[0])),
                   exchanges=COL.CALLS["all_to_all_single"] - a2a)
        return out
    rows = max(t.shape[2] for t in built.in_specs[2].values())
    cache = built.model.init_cache(B, rows)
    if kind == "prefill":
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (B, S),
                                         generator=gen, device=dev,
                                         dtype=torch.int32),
                 "prompt_lens": torch.full((B,), S, dtype=torch.int32,
                                           device=dev)}
        params, batch, cache = (place(params, sh[0]), place(batch, sh[1]),
                                place(cache, sh[2]))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        (tok, cache), t = timed_call(torch, built.fn, params, batch, cache)
        out.update(counts=ops.launch_counts(), tokens=[tok.cpu()], ms=[t],
                   cache=whole(cache, sh[2]),
                   exchanges=COL.CALLS["all_to_all_single"] - a2a)
        return out
    for t in cache.values():
        t.normal_(generator=gen).mul_(LAUNCH_CACHE_SCALE)
    tok = torch.randint(1, cfg.vocab_size, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    kv = torch.full((B,), S - 8, dtype=torch.int32, device=dev)
    params, tok, cache, kv = (place(params, sh[0]), place(tok, sh[1]),
                              place(cache, sh[2]), place(kv, sh[3]))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    toks, lps, ms = [], [], []
    for _ in range(MESH_SERVE_STEPS):
        (tok, lp, cache), t = timed_call(torch, built.fn, params, tok, cache,
                                         kv)
        toks.append(whole(tok, sh[1]).cpu())
        lps.append(whole(lp, sh[1]).cpu())
        ms.append(t)
        kv = kv + 1
    out.update(counts=ops.launch_counts(), tokens=toks, logprobs=lps, ms=ms,
               cache=whole(cache, sh[2]),
               exchanges=COL.CALLS["all_to_all_single"] - a2a)
    return out


def kind_of(shape_name: str) -> str:
    return {"train_4k": "train", "prefill_32k": "prefill"}.get(shape_name,
                                                               "decode")


def phase_mesh(torch, dev, launches):
    """The dense and MoE families' placed launch steps on the card: an
    NCCL world of one through a ``FileStore`` (no network), the (1, 1)
    ``("data", "model")`` ``DeviceMesh``; each ``MESH_RUNS`` run at full
    width, bf16, its depth cut: Granite-MoE-3B-A800M's train_4k,
    prefill_32k (the expert-parallel layer on the mesh, two
    ``all_to_all_single`` a layer a microbatch, against the dense layer
    on the local mesh, held also by ``MOE_EP_TOL``) and seqshard
    decode_32k, Qwen3-MoE-235B-A22B's
    ``decode_2d``, Qwen3-0.6B's train_4k, prefill_32k and decode_32k
    plans, Gemma2-2B's decode_32k and long_500k (its ring and global
    caches under ``seqshard``) and the ``decode_2d`` serve steps of
    Qwen1.5-110B and Nemotron-4-340B, each placed on the mesh and again
    on ``make_local_mesh()`` from the same seeds: tokens, log-probs,
    caches, loss, grad norm and every leaf after ``LAUNCH_STEPS`` steps
    equal bit for bit, and exactly the flash (prefill) and dense decode
    (serve: one a layer a step) launches (none in the train steps)."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch import plans
    from repro_torch.launch.mesh import make_compat_mesh, make_local_mesh
    tmp = tempfile.mkdtemp(prefix="mesh_")
    store = dist.FileStore(str(Path(tmp) / "store"), 1)
    cuda = dev.type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo", store=store, rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120),
                            device_id=dev if cuda else None)
    rows = []
    try:
        mesh = make_compat_mesh((1, 1), ("data", "model"), dev.type)
        for run_label, (arch, shape_name, S, B, depth) in MESH_RUNS.items():
            cfg = get_config(arch).replace(num_layers=depth)
            runs = {}
            for label, m in (("mesh", mesh), ("local", make_local_mesh())):
                runs[label] = mesh_step_run(torch, dev, cfg, arch, shape_name,
                                            S, B, m)
                launches[f"mesh_{run_label}_{label}"] = runs[label]["counts"]
                release(torch)
            a, b = runs["mesh"], runs["local"]
            equal = {"placed": a["placed"] and not b["placed"]}
            for k in ("loss", "grad_norm"):
                if k in a:
                    equal[k] = a[k] == b[k]
            if "leaves" in a:
                equal["leaves"] = all(torch.equal(x, y) for x, y in
                                      zip(a["leaves"], b["leaves"]))
            for k in ("tokens", "logprobs"):
                if k in a:
                    equal[k] = all(torch.equal(x, y)
                                   for x, y in zip(a[k], b[k]))
            if "cache" in a:
                equal["cache"] = all(torch.equal(a["cache"][k], b["cache"][k])
                                     for k in a["cache"])
            want = {"train_4k": {},
                    "prefill_32k": {"flash_attention": cfg.num_layers}
                    }.get(shape_name, {"ragged_decode_attention":
                                       cfg.num_layers * MESH_SERVE_STEPS})
            for label, r in runs.items():
                check_launches(f"mesh {run_label} on {label}", r["counts"],
                               want)
            # the expert-parallel layer on the mesh only: the prefill's two
            # exchanges a layer; the train's in whole passes of two a layer
            # a microbatch a step (forward, backward, remat's recompute)
            kind = kind_of(shape_name)
            per = 2 * cfg.num_layers * (1 if kind == "prefill" else
                                        LAUNCH_STEPS * plans.get_plan(
                                            arch, shape_name).microbatches)
            if cfg.family == "moe" and kind != "decode":
                equal["exchanges"] = (a["exchanges"] > 0
                                      and a["exchanges"] % per == 0
                                      and (kind == "train"
                                           or a["exchanges"] == per)
                                      and b["exchanges"] == 0)
            else:
                equal["exchanges"] = a["exchanges"] == b["exchanges"] == 0
            row = {"run": run_label, "model": cfg.name,
                   "layers": cfg.num_layers, "shape": shape_name, "seq": S,
                   "batch": B, "decode_2d": plans.get_plan(
                       arch, shape_name).decode_2d,
                   "equal": equal,
                   "ms": {k: r["ms"] for k, r in runs.items()},
                   "loss": a.get("loss"), "grad_norm": a.get("grad_norm"),
                   "tokens": [t.tolist() for t in a.get("tokens", [])],
                   "launches": {k: r["counts"] for k, r in runs.items()},
                   "all_to_all_single": {k: r["exchanges"]
                                         for k, r in runs.items()}}
            if cfg.family == "moe" and kind != "decode":
                # the expert-parallel step's own tolerances (MOE_EP_TOL),
                # beside the bits
                if kind == "train":
                    gap = max(leaf_gap(torch, y, x)[1]
                              for x, y in zip(a["leaves"], b["leaves"]))
                    near = all(math.isclose(
                        x, y, rel_tol=LAUNCH_STEP_TOL["rtol"],
                        abs_tol=LAUNCH_STEP_TOL["atol"])
                        for k in ("loss", "grad_norm")
                        for x, y in zip(a[k], b[k]))
                else:
                    gap = max(leaf_gap(torch, b["cache"][k], a["cache"][k])[1]
                              for k in a["cache"])
                    near = equal["tokens"]
                row["moe_ep_tol"] = {"rel_gap": gap, "steps_or_tokens": near,
                                     "tol": MOE_EP_TOL["bf16_rel"]}
                check(near and gap <= MOE_EP_TOL["bf16_rel"],
                      f"mesh {run_label}: past MOE_EP_TOL {row}")
            check(all(equal.values()), f"mesh {run_label}: the placed step "
                  f"differs from the local one {row}")
            rows.append(row)
            del runs, a, b, r
            release(torch)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "mesh", "card": card_name_and_power(),
          "backend": "nccl" if cuda else "gloo", "mesh": [1, 1],
          "runs": rows})


# ---------------------------------------------------------------------------
# Phase 8: the launch path (repro_torch/launch) at full width
# ---------------------------------------------------------------------------

# label -> (arch, seq, batch): build_train_step under get_plan(arch,
# "train_4k") (its remat, microbatches and moment dtype), every model at
# its published widths and depth, bf16, random weights from a seed, the
# launcher's batch (make_batch: random tokens and advantages, zero stub
# rows).  Cuts (LAUNCH_CUTS): the batch, from train_4k's 256 to what one
# card holds; xLSTM's seq.
LAUNCH_TRAIN = {
    "qwen3_0_6b": ("qwen3_0_6b", 4096, 2),
    "gemma2_2b": ("gemma2_2b", 4096, 4),
    "granite_moe": ("granite_moe_3b_a800m", 4096, 4),
    "phi3_vision": ("phi_3_vision_4_2b", 4096, 4),
    "whisper": ("whisper_small", 4096, 2),
    "zamba2": ("zamba2_1_2b", 4096, 4),
    "xlstm": ("xlstm_125m", 1024, 2),
}
# factors on the output projections at init, as in FAMILIES: Gemma2's
# tied, capped head is one-hot at the init scale, so every logprob is 0
# and the update's gradient ~1e-10 (loss 0.317986 at all 3 steps, grad
# norm 7.9e-11 at 1x on an H100 80GB HBM3 at 700 W)
LAUNCH_SCALES = {"gemma2_2b": {"wo": 8.0, "w_out": 8.0}}
LAUNCH_CUTS = {
    "batch": "train_4k's 256 rows cut to 2-4: one card, not a 256-chip pod",
    "xlstm_seq": "xLSTM at S 1024, not 4096: its sLSTM is a per-step loop "
                 "(3.06 s per 1024 steps on the H100, PERF.md section 5)",
    "prefill_batch": "prefill_32k's 32 rows cut to 1 (cache 3.82 GB and "
                     "bf16 logits 9.96 GB a row)",
    "decode_32k_batch": "decode_32k's 128 rows cut to 8 (30.5 GB of cache)",
    "train_depth": "launch_train at LAUNCH_DEPTH layers for five models "
                   "(full width) and 2 steps, not 3: the whole script's "
                   "time limit (its full run took 936 s of 1200 with the "
                   "train cells at 304 s)",
}
# layers of the launch_train models cut in depth (each family's layer
# pattern kept: Gemma2's local/global pairs, Zamba2's shared block after
# every 6 SSM layers and its 2-layer tail, xLSTM's mLSTM/sLSTM pairs);
# Qwen3-0.6B and Whisper-small run at full depth
LAUNCH_DEPTH = {"gemma2_2b": 8, "granite_moe": 8, "phi3_vision": 8,
                "zamba2": 8, "xlstm": 2}
LAUNCH_STEPS = 2            # update ms: the median of those after the first
LAUNCH_SERVE_STEPS = 8
LAUNCH_HOLD_SEQ = 1024      # the microbatch hold: 2 layers, f32, one batch
LAUNCH_TIE = 0.05           # logits: a tie inside both runs of the prefill
LAUNCH_STEP_TOL = dict(rtol=1e-4, atol=1e-6)   # tests/test_torch_rl.py:64
# label -> (arch, shape, batch): build_serve_step on a dense cache of the
# shape's rows filled with scaled random values, kv_len = S - 8
LAUNCH_SERVE = {
    "qwen3_decode_32k": ("qwen3_0_6b", "decode_32k", 8),
    "gemma2_long_500k": ("gemma2_2b", "long_500k", 1),
}
LAUNCH_CACHE_SCALE = 0.5
LAUNCH_PREFILL = ("qwen3_0_6b", 32_768, 1)     # arch, S, B (prefill_32k)


def flash_excess(got, want, args, kwargs):
    """The kernels phase's bf16 flash rule, less its 1e-3: <= 0 passes.
    |out - want| - 2^-7 |want| - 2^-9 attn(|v|) - 1e-3, attn(|v|) the
    plain version on |v|."""
    from repro_torch.kernels import ref
    q, k, v = args[:3]
    wabs = ref.flash_attention_rows_ref(q, k, v.abs(), **kwargs).float()
    w = want.float()
    return float(((got.float() - w).abs() - 2.0 ** -7 * w.abs()
                  - 2.0 ** -9 * wabs).max()) - 1e-3


class PlainWitness:
    """While installed, ``ops.<name>`` runs the kernel's plain version on
    the tensors the model gives it and launches the kernel beside it on
    the same inputs; each call's kernel output is held against the plain
    version's by ``excess(got, want, args, kwargs)`` (<= 0 passes), and
    the model goes on with the plain version's output, so a run under it
    is the plain-attention run of the same step (``PlainInt8Decode``'s
    pattern)."""

    def __init__(self, name, plain, excess):
        self.name, self.plain, self.excess_fn = name, plain, excess

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, kernel = ops, getattr(ops, self.name)
        self.kernel = kernel
        self.calls, self.max_abs, self.excess = 0, 0.0, -math.inf

        def witnessed(*args, **kwargs):
            got = kernel(*args, **kwargs)
            want = self.plain(*args, **kwargs)
            self.calls += 1
            self.max_abs = max(self.max_abs, float(
                (got.float() - want.float()).abs().max()))
            self.excess = max(self.excess,
                              self.excess_fn(got, want, args, kwargs))
            return want
        setattr(ops, self.name, witnessed)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.kernel)

    def summary(self, rule):
        return {"calls": self.calls, "max_abs_err": self.max_abs,
                "max_excess": self.excess, "tol_rule": rule,
                "ok": self.calls > 0 and self.excess <= 0}


class LastLogits:
    """While installed, keeps the f32 logits of the last column of every
    ``lm_logits`` call (the column the prefill step's argmax reads)."""

    def __enter__(self):
        from repro_torch.models import transformer as TF
        self.TF, real = TF, TF.lm_logits
        self.real, self.rows = real, []

        def recorded(params, cfg, x):
            out = real(params, cfg, x)
            self.rows.append(out[:, -1].float().clone())
            return out
        TF.lm_logits = recorded
        return self

    def __exit__(self, *exc):
        self.TF.lm_logits = self.real


def timed_call(torch, fn, *args):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn(*args)
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def launch_micro_hold(torch, dev, arch, plan):
    """The train step with the plan's microbatches against the same step at
    ``microbatches=1``, at 2 layers of the published width in f32 (a
    hybrid: one group of ``attn_every`` Mamba2 layers, the shared block
    and a tail layer), on one batch of the plan's microbatch count rows:
    the loss and every gradient leaf (captured at ``adamw_update``)
    within ``LAUNCH_STEP_TOL``.  An MoE's router statistics and capacity
    are per call, so there the step is held to its definition (each
    slice's value and gradient before the update, summed and divided by
    their count) and its distance to ``microbatches=1`` is reported."""
    import dataclasses as dc
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.rl.losses import LossConfig, total_loss
    from repro_torch.rl.trainer import value_and_grad
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    cfg = get_config(arch)
    layers = cfg.attn_every + 1 if cfg.family == "hybrid" else 2
    cfg = cfg.replace(num_layers=layers, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    n = plan.microbatches
    shape = ShapeConfig("train_4k", LAUNCH_HOLD_SEQ, n, "train")
    batch = train.make_batch(cfg, n, LAUNCH_HOLD_SEQ, dev,
                             torch.Generator().manual_seed(2))
    real = steps.adamw_update
    got = {}
    for micro in (n, 1):
        built = steps.build_train_step(
            cfg, shape, dc.replace(plan, microbatches=micro),
            make_local_mesh(), False)
        params = built.model.init_params(
            torch.Generator(device=dev).manual_seed(0))
        opt = init_opt_state(params, AdamWConfig(state_dtype=plan.opt_dtype))
        if cfg.family == "moe" and micro == n:
            def loss_fn(p, b, model=built.model):
                logits, aux = model.forward(p, b)
                return total_loss(logits, aux, b, LossConfig())
            gsum, lsum = None, 0.0
            for i in range(n):
                (l, _), g = value_and_grad(
                    loss_fn, params, {k: v[i:i + 1] for k, v in batch.items()})
                gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
                lsum = lsum + l
            got["definition"] = (lsum / n, [x / n for x in gsum])
            del gsum
        seen = {}

        def capture(p, grads, state, ocfg, seen=seen, **kw):
            seen["grads"] = [g.detach().clone() for g in grads]
            return real(p, grads, state, ocfg, **kw)
        steps.adamw_update = capture
        try:
            _, _, metrics = built.fn(params, opt, batch)
        finally:
            steps.adamw_update = real
        got[micro] = (metrics["loss"].detach().float().reshape(()),
                      seen["grads"])
        del built, params, opt, metrics
        release(torch)

    def gap(a, b):
        (la, ga), (lb, gb) = a, b
        tol = LAUNCH_STEP_TOL
        ok = bool(torch.isclose(la, lb, **tol))
        worst = float((la - lb).abs() - tol["rtol"] * lb.abs())
        for x, y in zip(ga, gb):
            ok &= bool(torch.isclose(x, y, **tol).all())
            worst = max(worst, float(((x - y).abs()
                                      - tol["rtol"] * y.abs()).max()))
        return ok, worst
    ok1, over1 = gap(got[n], got[1])
    row = {"arch": arch, "layers": layers, "dtype": "float32",
           "seq": LAUNCH_HOLD_SEQ, "batch": n, "microbatches": n,
           "tol": LAUNCH_STEP_TOL,
           "loss_micro": float(got[n][0]), "loss_whole": float(got[1][0]),
           "against_whole_within_tol": ok1,
           "against_whole_max_excess_over_rtol": over1}
    if "definition" in got:
        okd, overd = gap(got[n], got["definition"])
        row.update(held_to="definition", against_definition_within_tol=okd,
                   against_definition_max_excess_over_rtol=overd,
                   why="MoE capacity and router statistics are per call")
        check(okd, f"launch_train/{arch}: the microbatch step against its "
              f"definition {row}")
    else:
        row["held_to"] = "microbatches=1"
        check(ok1, f"launch_train/{arch}: microbatches={n} against 1 {row}")
    del got, batch
    release(torch)
    return row


def launch_train(torch, dev, launches):
    """Each ``LAUNCH_TRAIN`` model (at ``LAUNCH_DEPTH`` layers where cut):
    ``LAUNCH_STEPS`` steps of ``build_train_step`` under
    its train_4k plan, each timed with CUDA events (update ms: the median
    of the steps after the first), peak memory, loss and grad norm (held
    finite), the fit report's ``model_flops`` and
    ``persistent_bytes`` for the same config and shape (held: peak >=
    persistent bytes), the share model_flops / (update s x 989e12), no
    kernel launch (the train forward is plain PyTorch); then, where the
    plan has microbatches, ``launch_micro_hold``."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, steps, train
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, make_local_mesh
    from repro_torch.launch.plans import get_plan
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    rows = []
    for label, (arch, S, B) in LAUNCH_TRAIN.items():
        t0 = time.monotonic()
        cfg = get_config(arch)
        if label in LAUNCH_DEPTH:
            cfg = cfg.replace(num_layers=LAUNCH_DEPTH[label])
        plan = get_plan(arch, "train_4k")
        shape = ShapeConfig("train_4k", S, B, "train")
        built = steps.build_train_step(cfg, shape, plan, make_local_mesh(),
                                       False)
        sizes = dryrun.step_sizes(cfg, shape, built)
        params = built.model.init_params(
            torch.Generator(device=dev).manual_seed(0))
        for leaf, f in LAUNCH_SCALES.get(label, {}).items():
            with torch.no_grad():
                params["layers"]["attn" if leaf == "wo" else "mlp"][
                    leaf].mul_(f)
        opt = init_opt_state(params, AdamWConfig(state_dtype=plan.opt_dtype))
        batch = train.make_batch(cfg, B, S, dev,
                                 torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ms, losses, gnorms = [], [], []
        for _ in range(LAUNCH_STEPS):
            (params, opt, metrics), t = timed_call(torch, built.fn, params,
                                                   opt, batch)
            ms.append(t)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
        counts = ops.launch_counts()
        launches[f"launch_train_{label}"] = counts
        peak = torch.cuda.max_memory_allocated()
        update_s = statistics.median(ms[1:]) / 1e3
        check(all(math.isfinite(x) for x in losses + gnorms),
              f"launch_train/{label}: loss {losses}, grad norm {gnorms}")
        check(peak >= sizes["persistent_bytes"],
              f"launch_train/{label}: peak {peak} below the fit report's "
              f"persistent bytes {sizes['persistent_bytes']}")
        check(not any(counts.values()), f"launch_train/{label}: {counts}")
        row = {"label": label, "model": cfg.name, "layers": cfg.num_layers,
               "seq": S, "batch": B, "init_scales": LAUNCH_SCALES.get(label),
               "stub_rows": cfg.num_stub_positions if cfg.family in (
                   "vlm", "audio") else 0,
               "plan": {"remat": plan.remat,
                        "microbatches": plan.microbatches,
                        "opt_dtype": str(plan.opt_dtype)},
               "update_ms": ms, "update_ms_median": update_s * 1e3,
               "peak_gb": peak / 1e9, "loss": losses, "grad_norm": gnorms,
               **sizes, "persistent_gb": sizes["persistent_bytes"] / 1e9,
               "model_flops_share": sizes["model_flops"]
               / (update_s * PEAK_FLOPS_BF16),
               "launches": counts}
        del params, opt, batch, built, metrics
        release(torch)
        if plan.microbatches > 1:
            row["micro_hold"] = launch_micro_hold(torch, dev, arch, plan)
        row["wall_s"] = time.monotonic() - t0
        rows.append(row)
        emit({"phase": "launch_train", "card": card_name_and_power(), **row})
    return rows


def launch_prefill(torch, dev, launches):
    """``build_prefill_step`` on Qwen3-0.6B at prefill_32k's S = 32,768,
    B 1: twice on the kernel path (the second timed; counts zeroed just
    before it: exactly 28 flash launches, no decode), then under
    ``PlainWitness`` (flash's plain version at every call, the kernel held
    to it by the kernels phase's bf16 rule); the token against the
    plain-prefill run's, equal except at a tie inside both (the last
    column's logits of the two tokens within ``LAUNCH_TIE`` in each)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.plans import get_plan
    from repro_torch.launch.steps import build_prefill_step

    arch, S, B = LAUNCH_PREFILL
    cfg = get_config(arch)
    plan = get_plan(arch, "prefill_32k")
    built = build_prefill_step(cfg, ShapeConfig("prefill_32k", S, B,
                                                "prefill"),
                               plan, make_local_mesh(), False)
    rows = built.in_specs[2]["k"].shape[2]
    params = built.model.init_params(torch.Generator(device=dev)
                                     .manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(3)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (B, S), generator=g,
                                     device=dev, dtype=torch.int32),
             "prompt_lens": torch.full((B,), S, dtype=torch.int32,
                                       device=dev)}
    ms = []
    for rep in range(2):
        cache = built.model.init_cache(B, rows)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with LastLogits() as kernel_logits:
            (tok, cache), t = timed_call(torch, built.fn, params, batch,
                                         cache)
        counts = ops.launch_counts()
        ms.append(t)
        del cache
    peak = torch.cuda.max_memory_allocated()
    launches["launch_prefill"] = counts
    check_launches("launch_prefill", counts,
                   {"flash_attention": cfg.num_layers})
    release(torch)
    cache = built.model.init_cache(B, rows)
    with LastLogits() as plain_logits, PlainWitness(
            "flash_attention", ref.flash_attention_rows_ref,
            flash_excess) as witness:
        tok_plain, cache = built.fn(params, batch, cache)
    torch.cuda.synchronize()
    per_call = witness.summary("|out - want| <= 1e-3 + 2^-7 |want| + "
                               "2^-9 attn(|v|)")
    check(per_call["ok"] and per_call["calls"] == cfg.num_layers,
          f"launch_prefill: flash against its plain version {per_call}")
    a, p = kernel_logits.rows[-1], plain_logits.rows[-1]
    ties = []
    for b in range(B):
        ta, tp = int(tok[b]), int(tok_plain[b])
        if ta != tp:
            ties.append({"row": b, "kernel": ta, "plain": tp,
                         "gap_kernel": float(a[b, ta] - a[b, tp]),
                         "gap_plain": float(p[b, tp] - p[b, ta])})
    check(all(t["gap_kernel"] <= LAUNCH_TIE and t["gap_plain"] <= LAUNCH_TIE
              for t in ties),
          f"launch_prefill: tokens differ beyond a tie {ties}")
    row = {"phase": "launch_prefill", "model": cfg.name,
           "layers": cfg.num_layers, "seq": S, "batch": B, "cache_rows": rows,
           "card": card_name_and_power(),
           "step_ms": ms, "tokens_per_s": B * S / (ms[-1] / 1e3),
           "peak_gb": peak / 1e9,
           "cache_gb": sum(t.numel() * t.element_size()
                           for t in cache.values()) / 1e9,
           "logits_gb": B * S * cfg.vocab_size * 2 / 1e9,
           "token": tok.tolist(), "token_plain": tok_plain.tolist(),
           "tie_tol": LAUNCH_TIE, "ties": ties,
           "max_logit_diff_last_column": float((a - p).abs().max()),
           "flash_witness": per_call, "launches": counts}
    emit(row)
    del params, cache, built, batch
    release(torch)
    return row


def launch_serve_setup(torch, dev, arch, shape_name, B):
    """A ``LAUNCH_SERVE`` run's step and inputs: ``build_serve_step`` at
    the shape, its params from seed 0, a dense cache of
    ``_round_len(S + 8)`` rows filled with random values scaled by
    ``LAUNCH_CACHE_SCALE``, random tokens and kv_len = S - 8.  Returns
    (cfg, built, params, cache, tok, kv, cache rows, S)."""
    from repro_torch.configs.base import ShapeConfig, get_config, shape_by_name
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.plans import get_plan
    from repro_torch.launch.steps import build_serve_step
    cfg = get_config(arch)
    S = shape_by_name(shape_name).seq_len
    built = build_serve_step(cfg, ShapeConfig(shape_name, S, B, "decode"),
                             get_plan(arch, shape_name), make_local_mesh(),
                             False)
    rows = max(t.shape[2] for t in built.in_specs[2].values())
    params = built.model.init_params(torch.Generator(device=dev)
                                     .manual_seed(0))
    cache = built.model.init_cache(B, rows)
    g = torch.Generator(device=dev).manual_seed(4)
    for t in cache.values():
        t.normal_(generator=g).mul_(LAUNCH_CACHE_SCALE)
    tok = torch.randint(1, cfg.vocab_size, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    kv = torch.full((B,), S - 8, dtype=torch.int32, device=dev)
    return cfg, built, params, cache, tok, kv, rows, S


def launch_serve(torch, dev, launches):
    """Each ``LAUNCH_SERVE`` run: ``build_serve_step`` on a dense cache of
    the shape's rows (``_round_len(S + 8)``) filled with random values
    scaled by ``LAUNCH_CACHE_SCALE``, kv_len = S - 8, random tokens;
    ``LAUNCH_SERVE_STEPS`` steps on the kernel path, each timed (counts
    zeroed just before them: exactly the dense decode's launches, one per
    attention layer a step, nothing else), then as many under
    ``PlainWitness`` (the plain dense decode at every call, the kernel held
    to it by ``DECODE_RULE``); tokens and log-probs held finite."""
    from repro_torch.kernels import ops, ref

    out = []
    for label, (arch, shape_name, B) in LAUNCH_SERVE.items():
        cfg, built, params, cache, tok, kv, rows, S = launch_serve_setup(
            torch, dev, arch, shape_name, B)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ms, lps = [], []
        for _ in range(LAUNCH_SERVE_STEPS):
            (tok, lp, cache), t = timed_call(torch, built.fn, params, tok,
                                             cache, kv)
            ms.append(t)
            lps.append(lp.float().cpu())
            kv = kv + 1
        counts = ops.launch_counts()
        launches[f"launch_serve_{label}"] = counts
        check_launches(f"launch_serve_{label}", counts,
                       {"ragged_decode_attention":
                        cfg.num_layers * LAUNCH_SERVE_STEPS})
        peak = torch.cuda.max_memory_allocated()
        with PlainWitness("ragged_decode_attention",
                          ref.ragged_decode_attention_ref,
                          lambda got, want, a, k: decode_excess(got, want)[0]
                          ) as witness:
            for _ in range(LAUNCH_SERVE_STEPS):
                tok, lp, cache = built.fn(params, tok, cache, kv)
                lps.append(lp.float().cpu())
                kv = kv + 1
        torch.cuda.synchronize()
        per_call = witness.summary(DECODE_RULE)
        check(per_call["ok"] and per_call["calls"]
              == cfg.num_layers * LAUNCH_SERVE_STEPS,
              f"launch_serve/{label}: the dense decode against its plain "
              f"version {per_call}")
        lps = torch.stack(lps)
        check(bool(torch.isfinite(lps).all()) and bool((lps <= 0).all()),
              f"launch_serve/{label}: log-probs {lps}")
        med = statistics.median(ms)
        row = {"phase": "launch_serve", "label": label, "model": cfg.name,
               "layers": cfg.num_layers, "shape": shape_name, "seq": S,
               "batch": B, "cache_rows": rows, "kv_len_first": S - 8,
               "card": card_name_and_power(),
               "cache_gb": sum(t.numel() * t.element_size()
                               for t in cache.values()) / 1e9,
               "step_ms": ms, "step_ms_median": med,
               "tokens_per_s": B / (med / 1e3), "peak_gb": peak / 1e9,
               "logprob_mean": float(lps.mean()),
               "decode_witness": per_call, "launches": counts}
        emit(row)
        out.append(row)
        del params, cache, built, tok, lp
        release(torch)
    return out


def phase_launch(torch, dev, launches):
    """The launch path at full width: ``launch_train``, ``launch_prefill``
    and ``launch_serve``; one summary line with the cuts."""
    t0 = time.monotonic()
    train_rows = launch_train(torch, dev, launches)
    launch_prefill(torch, dev, launches)
    launch_serve(torch, dev, launches)
    emit({"phase": "launch", "cuts": LAUNCH_CUTS,
          "train_runs": len(train_rows), "seconds": time.monotonic() - t0})


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
                                        "group", "families", "moe_ep",
                                        "mesh", "launch"),
                    default="all")
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
    seconds, t_run = {}, time.monotonic()

    def run(name, fn, *a):
        """``fn(*a)``, its wall seconds kept under ``name``."""
        t0 = time.monotonic()
        res = fn(*a)
        seconds[name] = seconds.get(name, 0.0) + time.monotonic() - t0
        return res
    run("kernels", phase_kernels, torch, dev, report)
    if args.phase == "variants":
        run("variants", phase_variants, torch, dev)
    if args.phase == "all":
        model, params = run("serve", phase_serve, torch, dev, launches, keep)
        run("e2e", phase_e2e, torch, dev, keep, model, params)
    if args.phase in ("rl", "group"):
        from repro_torch.configs.base import get_config
        from repro_torch.models.model import build_model
        model = build_model(get_config("qwen3_0_6b"))
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if args.phase in ("all", "group"):
        run("group", phase_group, torch, dev, model, params, launches)
        run("serve_tier", phase_serve_tier, torch, dev, model, params,
            launches)
    if args.phase in ("all", "rl"):
        run("rl", phase_rl, torch, dev, model, params, launches)
    if args.phase in ("all", "group"):
        run("long", phase_long, torch, dev, model, params, launches)
    if args.phase in ("all", "rl", "group"):
        del model, params
        release(torch)
        run("rl_session", phase_rl_session, torch, launches,
            args.phase == "group")
    if args.phase in ("all", "families", "moe_ep"):
        run("moe_layer", moe_layer_check, torch, dev)
        run("moe_ep", phase_moe_ep, torch, dev, launches)
    if args.phase in ("all", "mesh"):
        release(torch)
        run("mesh", phase_mesh, torch, dev, launches)
    if args.phase in ("all", "families"):
        run("families", phase_families, torch, dev, launches)
        run("rl_moe", phase_rl_moe, torch, dev, launches)
        run("rl_vlm", phase_rl_vlm, torch, dev, launches)
        run("rl_hybrid", phase_rl_hybrid, torch, dev, launches)
    if args.phase in ("all", "launch"):
        release(torch)
        run("launch", phase_launch, torch, dev, launches)
    emit({"phase": "seconds", "phases": seconds,
          "total": time.monotonic() - t_run})
    emit({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches.get(path, {}).get(name, 0), path=path,
             launches_per_path={p: c.get(name, 0)
                                for p, c in launches.items()},
             max_abs_err=report[name]["max_abs_err"], tol=report[name]["tol"],
             rtol=report[name].get("rtol", 0.0),
             tol_rule=report[name].get("tol_rule"),
             ms=report[name]["ms"], kernel_ms=report[name]["kernel_ms"],
             kernels_per_call=report[name][
                 "kernels_per_call"],
             plain_ms=report[name]["plain_ms"],
             bound_ms=report[name]["bound_ms"],
             bound_by=report[name]["bound_by"],
             library_ms=report[name]["library_ms"],
             sass_bf16=report[name]["sass_bf16"],
             registers=report[name].get("registers"),
             shape=report[name]["shape"],
             family_shapes=report[name].get("family_shapes", []))
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
