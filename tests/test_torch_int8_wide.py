"""int8 KV pages at the paged families' wide heads, on the CPU:
Nemotron-4-340B (H 96 over Kh 8, D 192), Qwen3-MoE-235B-A22B (H 64 over
Kh 4, D 128) and Phi-3-Vision-4.2B (H 32 over Kh 32, D 96).

* The port's plain ``quantize_pages_ref`` equals the reference's byte for
  byte and scale for scale (an all-zero page at the 1e-8 floor), and its
  plain ``paged_decode_attention_int8_ref`` equals the reference's at the
  three published (H, Kh, D), B 2-3, pages of 16 rows, a zero page and a
  slot at kv_len 0, from numpy inputs of a seed: f32 q within
  ``tests/test_torch_kernels.py``'s 1e-5; bf16 q by ``chip_smoke.py``'s
  bf16 decode rule, 2^-7 |want| + 2^-5 rms(want[slot]) (the reference's
  jnp decode rounds the dequantised K/V to q's dtype, the port's plain
  version keeps them in f32 as the kernel does; both round the output to
  bf16).
* The decode kernels' gate (``build.decode_shape_ok``) admits int8 pages
  with bf16 q at the three shapes and refuses them at Gemma2-2B's
  (256, 2), which serves on the dense layout, and refuses f32 q at every
  wide shape.
* The Nemotron smoke config's int8 engine against the reference's
  ``SlotEngine(kv_quant="int8")``: greedy tokens equal, logprobs within
  ``tests/test_torch_engine.py``'s ``INT8_LP_TOL`` (f32 sum order can tip
  a cell at an int8 rounding tie to the next step; helpers of
  ``tests/test_torch_families.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from repro.kernels import ref as jref
from repro.core.buffer import BufferEntry as JEntry
from repro.rollout.engine import SlotEngine as JEngine
from repro_torch.core.buffer import BufferEntry as TEntry
from repro_torch.kernels import build, ref
from repro_torch.rollout.engine import SlotEngine
from test_torch_engine import INT8_LP_TOL
from test_torch_families import KW, _models, _prompts, _serve

WIDE_INT8 = [(96, 8, 192), (64, 4, 128), (32, 32, 96)]   # (H, Kh, D)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_RTOL, BF16_RMS = 2.0 ** -7, 2.0 ** -5      # chip_smoke.DECODE_RULE


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _pages(H, Kh, D, lens, seed, P=16):
    """q (B, H, D), k/v pages (N, P, Kh, D) with page 1 all zero, block
    tables (B, nb) of distinct pages, kv_len (B,)."""
    rng = np.random.RandomState(seed)
    B, nb = len(lens), max(-(-n // P) for n in lens) + 1
    N = B * nb + 2
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(N, P, Kh, D).astype(np.float32)
    vp = rng.randn(N, P, Kh, D).astype(np.float32)
    kp[1] = vp[1] = 0.0
    bt = (2 + np.arange(B * nb)).reshape(B, nb).astype(np.int32)
    bt[0, 0] = 1                      # slot 0 starts on the zero page
    return q, kp, vp, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("H,Kh,D", WIDE_INT8)
def test_quantize_pages_matches_reference(H, Kh, D):
    _, kp, _, _, _ = _pages(H, Kh, D, [40, 5], seed=D)
    q8, sc = ref.quantize_pages_ref(_t(kp))
    jq8, jsc = jref.quantize_pages_ref(jnp.asarray(kp))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert not q8[1].any() and float(sc[1]) == np.float32(1e-8) / 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Kh,D", WIDE_INT8)
def test_int8_decode_plain_matches_reference(H, Kh, D, dtype):
    lens = [40, 0, 17] if D != 128 else [33, 0]
    q, kp, vp, bt, kv = _pages(H, Kh, D, lens, seed=H + D)
    (kq, ksc), (vq, vsc) = (jref.quantize_pages_ref(jnp.asarray(p))
                            for p in (kp, vp))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ref.paged_decode_attention_int8_ref(
        _t(q).to(tdt), *map(_t, (kq, vq, ksc, vsc, bt, kv)))
    want = jref.paged_decode_attention_int8_ref(
        jnp.asarray(q).astype(jdt), kq, vq, ksc, vsc, jnp.asarray(bt),
        jnp.asarray(kv))
    assert got.dtype == tdt and got.shape == (len(lens), H, D)
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **F32_TOL)
    else:
        live = kv > 0
        rms = np.sqrt((w[live] ** 2).mean(axis=(1, 2)))[:, None, None]
        excess = (np.abs(g[live] - w[live]) - BF16_RTOL * np.abs(w[live])
                  - BF16_RMS * rms)
        assert excess.max() <= 0, (float(np.abs(g - w).max()), excess.max())
    assert not got[1].any()                   # kv_len 0: zeros


@pytest.mark.parametrize("D,G", [(192, 12), (128, 16), (96, 1)])
def test_gate_admits_int8_pages_at_the_wide_heads(D, G):
    assert build.decode_shape_ok(D, G, torch.bfloat16, int8=True)
    assert build.decode_shape_ok(D, G, torch.bfloat16)
    assert not build.decode_shape_ok(D, G, torch.float32, int8=True)
    assert not build.decode_shape_ok(D, G, torch.float32)


def test_gate_refuses_int8_pages_at_gemma2s_head():
    assert build.decode_shape_ok(256, 2, torch.bfloat16)
    assert not build.decode_shape_ok(256, 2, torch.bfloat16, int8=True)
    assert not build.decode_shape_ok(256, 2, torch.float32, int8=True)
    assert build.DECODE_INT8_WIDE_SHAPES < build.DECODE_WIDE_SHAPES


def test_nemotron_int8_engine_matches_reference_engine():
    """10 requests through 4 slots on int8 pages: greedy tokens and
    finishes equal, logprobs within ``INT8_LP_TOL``, the same prefill
    launches."""
    jm, jp, tm, tp = _models("nemotron_4_340b")
    es = list(enumerate(_prompts(10, 3, 2, 40)))
    args = dict(KW, kv_quant="int8")
    je = JEngine(jm, lambda: jp, **args)
    te = SlotEngine(tm, lambda: tp, **args)
    assert te.kv_quant == "int8" and te.paged
    want = _serve(je, [JEntry(uid=i, prompt=p) for i, p in es])
    got = _serve(te, [TEntry(uid=i, prompt=p) for i, p in es])
    assert set(got) == set(want)
    for uid in want:
        assert [x[0] for x in got[uid]] == [x[0] for x in want[uid]], uid
        assert [x[2:] for x in got[uid]] == [x[2:] for x in want[uid]], uid
        np.testing.assert_allclose([x[1] for x in got[uid]],
                                   [x[1] for x in want[uid]],
                                   atol=INT8_LP_TOL, rtol=0)
    assert te.prefill_launches == je.prefill_launches
