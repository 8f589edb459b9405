#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                  # all three phases
    python3 chip_smoke.py --phase kernels  # build + kernel checks only

Phases, each printing one JSON line:

1. ``kernels``: build the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` and hold each against its plain PyTorch version on the card, at
   the serve phase's shapes and at edge shapes, with the tolerance stated
   beside each case; time kernel, plain version and a PyTorch yardstick
   (``library_ms``, never called by the port) with CUDA events.
2. ``serve``: Qwen3-0.6B at full width and depth (28 layers, bf16, random
   weights from a seed) behind the paged ``SlotEngine``: 96 requests (24
   GRPO groups of 4 sharing a prompt of 64-1024 tokens), continuous
   batching as in ``examples/serve_batch.py``; then one packed-prefill
   wave and a few sampled steps.  Kernel launch counts are read around
   each path.
3. ``e2e``: greedy engine tokens and logprobs against the port's plain
   full-sequence ``forward`` (plain attention, no kernels): 4 layers in
   f32, and 4 requests of phase 2 in bf16.

Then the ``kernels`` summary line, the card's name and power limit from
``nvidia-smi``, and last ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero.  Needs one CUDA card; details go to ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import json
import math
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def phase_kernels(torch, dev, report):
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref

    t0 = time.monotonic()
    libs = build.build_all()
    build_s = time.monotonic() - t0
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.txt").write_text("\n".join(
        f"== {n}\n{build.ptxas_report(n)}" for n in libs))
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
    rng = np.random.RandomState(11)
    serve_lens = rng.randint(64, 1025, size=32) + rng.randint(0, 129, size=32)
    pd_cases = [
        ("serve_b32_bf16", bf16, serve_lens.tolist(), 16, 8, 128, 0.0),
        ("serve_b32_f32", f32, serve_lens.tolist(), 16, 8, 128, 0.0),
        ("kvlen_0_1_37_bf16", bf16, [0, 1, 37], 16, 8, 128, 0.0),
        ("kvlen_0_1_37_f32", f32, [0, 1, 37], 16, 8, 128, 0.0),
        ("d64_g4_softcap_f32", f32, [5, 16, 33, 300], 8, 2, 64, 30.0),
        ("d64_g1_bf16", bf16, [17, 129, 1], 4, 4, 64, 0.0),
        ("d128_g8_softcap_bf16", bf16, [100, 256, 31], 8, 1, 128, 30.0),
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
    report["paged_decode_attention"] = dict(
        max_abs_err=row["max_abs_err"], tol=row["tol"],
        ms=cuda_ms(torch, lambda: ops.paged_decode_attention(*args)),
        plain_ms=cuda_ms(torch, lambda: ref.paged_decode_attention_ref(*args),
                         reps=5, inner=3),
        library_ms=cuda_ms(torch, library, reps=5, inner=3),
        bound_ms=1e3 * max(nbytes / PEAK_BYTES_S,
                           flops / PEAK_FLOPS["bfloat16"]),
        bound_by="bytes" if nbytes / PEAK_BYTES_S
        >= flops / PEAK_FLOPS["bfloat16"] else "operations",
        shape=dict(B=B, H=H, Kh=Kh, D=D, P=16, live_rows=live))

    # -- flash_attention ------------------------------------------------------
    # tolerance: f32 1e-4 (only the order of f32 sums differs).  bf16:
    # 1e-3 + 2^-7*|want|.  Both sides compute in f32 from the same bf16
    # inputs and round only the output to bf16, so two f32 results a sum
    # order apart can land one bf16 step apart, and one step is at most
    # 2^-7 of the value; 1e-3 covers outputs near zero.  Late causal rows
    # average hundreds of keys (|out| ~ 0.05), so an absolute bound would
    # be blind to a dropped or doubled K tile there; this one is not.
    fa_rtol = 2.0 ** -7
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
            row = record("flash_attention", name, maxerr(out, want), 1e-3,
                         excess=max_excess(out, want, fa_rtol), rtol=fa_rtol)
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
    report["flash_attention"] = dict(
        max_abs_err=row["max_abs_err"], tol=row["tol"], rtol=row["rtol"],
        ms=cuda_ms(torch, lambda: ops.flash_attention(q, k, v), reps=5,
                   inner=3),
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention_ref(q, k, v),
                         reps=3, inner=2),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=5, inner=3),
        bound_ms=1e3 * max(nbytes / PEAK_BYTES_S,
                           flops / PEAK_FLOPS["bfloat16"]),
        bound_by="bytes" if nbytes / PEAK_BYTES_S
        >= flops / PEAK_FLOPS["bfloat16"] else "operations",
        shape=dict(B=B, S=S, H=H, Kh=Kh, D=D, causal_flops=flops))
    del qt, kt, vt

    # -- fused_sample ---------------------------------------------------------
    # tolerance 1e-3 on values and lse (logits O(1), lse ~12; both sides
    # multiply the same values in f32, only the sum order differs); indices:
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
    report["fused_sample"] = dict(
        max_abs_err=serve_row["max_abs_err"], tol=serve_row["tol"],
        ms=cuda_ms(torch, lambda: ops.fused_sample(x, w)),
        plain_ms=cuda_ms(torch, lambda: ref.fused_sample_ref(x, w),
                         reps=5, inner=3),
        library_ms=cuda_ms(torch, library, reps=5, inner=3),
        bound_ms=1e3 * max(nbytes / PEAK_BYTES_S,
                           flops / PEAK_FLOPS["bfloat16"]),
        bound_by="bytes" if nbytes / PEAK_BYTES_S
        >= flops / PEAK_FLOPS["bfloat16"] else "operations",
        shape=dict(B=B, Dm=Dm, V=V, w="embed.T (strided)"))
    del embed, x, w
    torch.cuda.empty_cache()
    (OUT / "chip_smoke_kernel_cases.json").write_text(
        json.dumps(cases, indent=1))
    emit({"phase": "kernels", "build_s": round(build_s, 3),
          "cases": len(cases), "cases_ok": sum(c["ok"] for c in cases),
          "timing": report})


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


def profile_steps(engine, n, outputs):
    """Device busy share of ``n`` decode steps (no submits in between):
    the summed time of the CUDA kernels over the steps' wall time, from
    torch.profiler; the wall time includes the profiler's own overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            for ev in engine.step():
                outputs.setdefault(ev.uid, []).append((ev.token, ev.logprob))
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(r.self_device_time_total for r in rows) / 1e3
    top = sorted(rows, key=lambda r: -r.self_device_time_total)[:8]
    return {"wall_ms_per_step": wall / n,
            "device_ms_per_step": dev_ms / n,
            "device_busy_share": dev_ms / wall if dev_ms else "not measured",
            "kernel_launches_per_step": sum(r.count for r in rows) / n,
            "top_kernels_ms_per_step": {
                r.key[:60]: r.self_device_time_total / 1e3 / n for r in top}}


def phase_serve(torch, dev, launches, keep):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.rollout.engine import SlotEngine

    cfg = get_config("qwen3_0_6b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    eos = 151645
    kw = dict(capacity=32, max_total_len=2048, max_gen_len=128, eos_id=eos,
              pad_id=0)

    engine = SlotEngine(model, lambda: params, fused_sampling=True,
                        temperature=0.0, **kw)
    reqs = make_requests(24, 4, 64, 1024, cfg.vocab_size, seed=1)
    prompts = {e.uid: list(e.prompt) for e in reqs}
    outputs, step_ms = {}, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    steps = serve_loop(engine, list(reqs), outputs, step_ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["main"] = ops.launch_counts()
    stats = engine.cache_stats()
    tokens = sum(len(v) for v in outputs.values())
    check(len(outputs) == 96 and all(len(v) >= 1 for v in outputs.values()),
          "serve: not every request answered")
    check(all(math.isfinite(lp) and 0 <= t < cfg.vocab_size
              for v in outputs.values() for t, lp in v),
          "serve: token out of range or non-finite logprob")
    check(all(n > 0 for n in launches["main"].values()),
          f"serve: a kernel was never launched: {launches['main']}")
    check(stats["prefill_tokens_saved"] > 0, "serve: no prefix sharing")
    keep["serve"] = {u: (prompts[u], outputs[u]) for u in range(4)}
    del engine
    torch.cuda.empty_cache()

    # one packed-prefill wave (segment-masked flash prefill); after the
    # main path's timing, 4 of its decode steps are traced
    packed = SlotEngine(model, lambda: params, fused_sampling=True,
                        temperature=0.0, packed_prefill=True, **kw)
    wave = make_requests(8, 4, 64, 1024, cfg.vocab_size, seed=2,
                         start_uid=1000)
    out_p, ms_p = {}, []
    prof = {"at": 64, "steps": 4}
    ops.reset_launch_counts()
    serve_loop(packed, wave, out_p, ms_p, prof)
    torch.cuda.synchronize()
    launches["packed"] = ops.launch_counts()
    check(packed.prefill_launches == 1 and len(out_p) == 32,
          f"packed wave: {packed.prefill_launches} prefill launches")
    del packed
    torch.cuda.empty_cache()

    # a few sampled steps (temperature 1.0: the plain head + multinomial)
    sampled = SlotEngine(model, lambda: params, fused_sampling=True,
                         temperature=1.0, seed=5, **kw)
    sampled.submit(make_requests(2, 4, 64, 512, cfg.vocab_size, seed=3,
                                 start_uid=2000), 0)
    ops.reset_launch_counts()
    evs = [ev for _ in range(8) for ev in sampled.step()]
    torch.cuda.synchronize()
    launches["sampled"] = ops.launch_counts()
    check(len(evs) == 64 and all(math.isfinite(ev.logprob)
                                 and 0 <= ev.token < cfg.vocab_size
                                 for ev in evs), "sampled steps")
    del sampled
    torch.cuda.empty_cache()

    decode_ms = sorted(step_ms)
    emit({"phase": "serve", "model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "dtype": "bfloat16",
          "requests": len(outputs), "tokens": tokens, "steps": steps,
          "wall_s": wall, "tokens_per_s": tokens / wall,
          "decode_step_ms_median": statistics.median(decode_ms),
          "decode_step_ms_p90": decode_ms[int(0.9 * (len(decode_ms) - 1))],
          "cache_stats": stats, "launches": launches,
          "packed_wave": {"requests": len(out_p),
                          "tokens": sum(len(v) for v in out_p.values()),
                          "decode_step_ms_median": statistics.median(ms_p),
                          "decode_profile": prof},
          "sampled_steps": {"events": len(evs)},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
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
    eng = SlotEngine(model, lambda: params, capacity=8, max_total_len=2048,
                     max_gen_len=24, eos_id=-1, fused_sampling=True,
                     temperature=0.0)
    reqs = make_requests(3, 2, 20, 700, cfg.vocab_size, seed=4)
    prompts = {e.uid: list(e.prompt) for e in reqs}
    outs, ms = {}, []
    serve_loop(eng, list(reqs), outs, ms)
    f32_tok_mismatch, f32_lp_err = 0, 0.0
    for uid, gen in outs.items():
        am, lp, _ = score(torch, model, params, prompts[uid], gen)
        f32_tok_mismatch += sum(a != t for a, (t, _) in zip(am, gen))
        f32_lp_err = max(f32_lp_err, max(abs(a - l) for a, (_, l)
                                         in zip(lp, gen)))
    check(f32_tok_mismatch == 0, f"e2e f32: {f32_tok_mismatch} tokens differ")
    check(f32_lp_err <= 1e-3, f"e2e f32: logprob err {f32_lp_err}")
    del eng, params
    torch.cuda.empty_cache()

    # bf16, 28 layers, 4 requests of the serve phase.  Tolerance 0.1 nats:
    # the engine's cached K/V, its f32-softmax kernels and its fused head
    # round at other points than one bf16 forward over the whole sequence
    # (each bf16 rounding is 2^-9 relative, over 28 layers of residual
    # updates); a token may differ from the forward's argmax only where the
    # forward itself has a near-tie within that tolerance.
    tol = 0.1
    bf_lp_err, flips, bad_flips, n = 0.0, 0, 0, 0
    for uid, (prompt, gen) in keep["serve"].items():
        am, lp, mx = score(torch, bf16_model, bf16_params, prompt, gen)
        for a, l, m, (t, lt) in zip(am, lp, mx, gen):
            n += 1
            bf_lp_err = max(bf_lp_err, abs(l - lt))
            if a != t:
                flips += 1
                bad_flips += (m - l) > tol
    check(bf_lp_err <= tol, f"e2e bf16: logprob err {bf_lp_err} > {tol}")
    check(bad_flips == 0, f"e2e bf16: {bad_flips} tokens differ beyond a "
          f"near-tie of {tol}")
    emit({"phase": "e2e",
          "f32_4layer": {"requests": len(outs),
                         "tokens": sum(len(v) for v in outs.values()),
                         "token_mismatches": f32_tok_mismatch,
                         "max_logprob_err": f32_lp_err, "tol": 1e-3},
          "bf16_28layer": {"requests": len(keep["serve"]), "tokens": n,
                           "argmax_flips": flips, "flips_beyond_tol":
                           bad_flips, "max_logprob_err": bf_lp_err,
                           "tol": tol}})


# ---------------------------------------------------------------------------

KERNEL_META = {
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "src/repro/kernels/ragged_decode_attention.py:174"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:87"),
    "fused_sample": (
        "src/repro_torch/kernels/csrc/fused_sample.cu",
        "src/repro/kernels/ragged_decode_attention.py:308"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels"), default="all")
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
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    report, launches, keep = {}, {}, {}
    phase_kernels(torch, dev, report)
    if args.phase == "all":
        model, params = phase_serve(torch, dev, launches, keep)
        phase_e2e(torch, dev, keep, model, params)
    main_counts = launches.get("main", {})
    emit({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=main_counts.get(name, 0),
             max_abs_err=report[name]["max_abs_err"], tol=report[name]["tol"],
             rtol=report[name].get("rtol", 0.0),
             ms=report[name]["ms"], kernel_ms=report[name]["ms"],
             plain_ms=report[name]["plain_ms"],
             bound_ms=report[name]["bound_ms"],
             bound_by=report[name]["bound_by"],
             library_ms=report[name]["library_ms"],
             shape=report[name]["shape"])
        for name, (src, rep) in KERNEL_META.items()]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
