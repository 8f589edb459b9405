"""Kernels of the PyTorch port (``repro_torch.kernels``) on the CPU.

* Each plain version against the reference package's ``kernels/ref.py``
  on the same numpy inputs, f32, atol = rtol = 1e-5 (int8 quantization:
  bytes and scales exactly).
* Small cases of each against the Pallas kernel in interpret mode,
  through ``repro.kernels.ops`` as ``tests/test_kernels.py`` runs them.
* int8 pages stay within ``KV_INT8_DECODE_ATOL`` of the fp decode on the
  same pages.
* ``chip_smoke.py``'s bf16 decode rule against the kernels' split-KV
  arithmetic in f32, and against the same with one split weighted wrong.
* The CUDA wrappers' guards: a CUDA-only argument and a non-CPU tensor
  raise instead of falling back (checked on meta tensors).
* The CUDA kernels against their plain versions run on the card in
  ``chip_smoke.py``; the CUDA wrappers' guards on a real card are in
  ``test_torch_kernels_gpu.py`` (no JAX there, so it runs on the card's
  host).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import build, ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _paged(rng, B, H, Kh, D, P, N, nb, lens=None):
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(N, P, Kh, D).astype(np.float32)
    vp = rng.randn(N, P, Kh, D).astype(np.float32)
    bt = rng.randint(0, N, size=(B, nb)).astype(np.int32)
    kv = (np.asarray(lens, np.int32) if lens is not None
          else rng.randint(0, nb * P + 1, size=B).astype(np.int32))
    return q, kp, vp, bt, kv


def _dense(rng, B, S, H, Kh, D, lens):
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, S, Kh, D).astype(np.float32)
    v = rng.randn(B, S, Kh, D).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


def _quantized(pages):
    q8, sc = jref.quantize_pages_ref(jnp.asarray(pages))
    return np.asarray(q8), np.asarray(sc)


def _packed_seg(rng, B, S, P):
    seg = np.full((B, S), -1, np.int32)
    for b in range(B):
        off, i = 0, 0
        while True:
            span = int(rng.randint(1, 4)) * P
            if off + span > S - P // 2:
                break
            seg[b, off:off + span] = i
            off, i = off + span, i + 1
    return seg


# -- plain versions against the reference's refs -----------------------------

def test_gather_pages_matches_reference():
    rng = np.random.RandomState(0)
    _, kp, _, bt, _ = _paged(rng, 3, 4, 2, 8, 16, 7, 3)
    np.testing.assert_array_equal(
        ref.gather_pages(_t(kp), _t(bt)).numpy(),
        np.asarray(jref.gather_pages(jnp.asarray(kp), jnp.asarray(bt))))


@pytest.mark.parametrize("B,H,Kh,D,P,N,nb,softcap", [
    (4, 8, 2, 64, 16, 9, 4, 0.0),
    (2, 16, 8, 128, 16, 11, 5, 0.0),
    (3, 4, 4, 32, 16, 6, 2, 30.0),
    (2, 4, 1, 16, 8, 5, 3, 0.0),
    (2, 24, 2, 192, 16, 7, 3, 50.0),            # Nemotron: D 192, G 12
    (2, 4, 2, 256, 16, 7, 3, 50.0),             # Gemma2: D 256, G 2
    (3, 24, 8, 64, 16, 9, 4, 0.0),              # Granite-MoE: D 64, G 3
    (2, 32, 2, 128, 16, 7, 3, 0.0),             # Qwen3-MoE: D 128, G 16
])
def test_paged_decode_plain_matches_reference(B, H, Kh, D, P, N, nb, softcap):
    rng = np.random.RandomState(B * 100 + D)
    q, kp, vp, bt, kv = _paged(rng, B, H, Kh, D, P, N, nb)
    kv[0] = 0                                   # empty slot -> zeros
    out = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(kv),
                                     softcap=softcap)
    want = jref.paged_decode_attention_ref(*map(jnp.asarray, (q, kp, vp, bt,
                                                              kv)),
                                           softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    assert not out[0].any()


@pytest.mark.parametrize("B,S,H,Kh,D,lens,softcap", [
    (4, 64, 8, 2, 64, [0, 1, 37, 64], 0.0),     # kv_len 0, 1, 37, S
    (3, 300, 16, 8, 128, [299, 5, 400], 0.0),   # S % 128 != 0, kv_len > S
    (2, 48, 4, 4, 32, [17, 48], 30.0),           # softcap, G = 1
    (2, 16, 8, 1, 16, [3, 16], 0.0),             # G = 8
    (2, 40, 8, 4, 256, [17, 40], 50.0),          # Gemma2: D 256, G 2
    (3, 24, 24, 2, 192, [0, 5, 24], 50.0),       # D 192, G 12
    (3, 40, 24, 8, 64, [0, 17, 40], 0.0),        # Granite-MoE: D 64, G 3
    (2, 24, 32, 2, 128, [5, 24], 0.0),           # Qwen3-MoE: D 128, G 16
])
def test_ragged_decode_plain_matches_reference(B, S, H, Kh, D, lens, softcap):
    rng = np.random.RandomState(S + D)
    q, k, v, kv = _dense(rng, B, S, H, Kh, D, lens)
    out = ops.ragged_decode_attention(_t(q), _t(k), _t(v), _t(kv),
                                      softcap=softcap)
    want = jref.ragged_decode_attention_ref(
        *map(jnp.asarray, (q, k, v, kv)), softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    assert not out[kv == 0].any()


def test_quantize_and_dequantize_pages_match_reference():
    """Bytes and scales exactly (round half to even in both; x.5 cells
    included), an all-zero page at the 1e-8 scale floor, dequantized
    pages exactly."""
    rng = np.random.RandomState(8)
    pages = rng.randn(6, 16, 2, 32).astype(np.float32)
    pages[0] = 0.0                              # scale floor: 1e-8 / 127
    pages[1, 0, 0, :3] = [127.0, 0.5, -2.5]     # scale 1: ties at .5
    q8, sc = ref.quantize_pages_ref(_t(pages))
    jq8, jsc = _quantized(pages)
    assert q8.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q8.numpy(), jq8)
    np.testing.assert_array_equal(sc.numpy(), jsc)
    assert q8[1, 0, 0, :3].tolist() == [127, 0, -2]
    assert not q8[0].any() and float(sc[0]) == np.float32(1e-8) / 127
    np.testing.assert_array_equal(
        ref.dequantize_pages_ref(q8, sc).numpy(),
        np.asarray(jref.dequantize_pages_ref(jnp.asarray(jq8),
                                             jnp.asarray(jsc))))


@pytest.mark.parametrize("B,H,Kh,D,P,N,nb,softcap", [
    (4, 8, 2, 64, 16, 9, 4, 0.0),
    (2, 16, 8, 128, 16, 11, 5, 30.0),
    (3, 4, 1, 32, 8, 6, 3, 0.0),
    (3, 24, 8, 64, 16, 9, 4, 0.0),              # Granite-MoE: D 64, G 3
])
def test_paged_int8_plain_matches_reference(B, H, Kh, D, P, N, nb, softcap):
    rng = np.random.RandomState(N + D)
    q, kp, vp, bt, kv = _paged(rng, B, H, Kh, D, P, N, nb)
    kv[0] = 0
    (kq, ksc), (vq, vsc) = _quantized(kp), _quantized(vp)
    out = ops.paged_decode_attention_int8(
        *map(_t, (q, kq, vq, ksc, vsc, bt, kv)), softcap=softcap)
    want = jref.paged_decode_attention_int8_ref(
        *map(jnp.asarray, (q, kq, vq, ksc, vsc, bt, kv)), softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    assert not out[0].any()


@pytest.mark.parametrize("B,H,Kh,D,P,N,nb,softcap,lens", [
    (4, 8, 2, 64, 16, 9, 4, 0.0, [0, 1, 16, 64]),      # 64: the table's end
    (3, 16, 8, 128, 16, 11, 3, 30.0, [17, 33, 5]),
])
def test_paged_int8_plain_with_new_rows_matches_reference_order(
        B, H, Kh, D, P, N, nb, softcap, lens):
    """The plain int8 decode with the slots' new rows against the
    reference engine's order: gather and dequantise the pages, set each
    slot's row ``kv_len - 1`` to its unquantised new row, then the jnp
    ``decode_attention``.  The new rows are 3x the pages' scale, so
    quantised they would have raised their page's scale."""
    rng = np.random.RandomState(B * N + D)
    q, kp, vp, bt, kv = _paged(rng, B, H, Kh, D, P, N, nb, lens=lens)
    kn, vn = (3 * rng.randn(B, Kh, D).astype(np.float32) for _ in range(2))
    (kq, ksc), (vq, vsc) = _quantized(kp), _quantized(vp)
    out = ops.paged_decode_attention_int8(
        *map(_t, (q, kq, vq, ksc, vsc, bt, kv)), softcap=softcap,
        k_new=_t(kn), v_new=_t(vn))
    views = []
    for pages, sc, new in ((kq, ksc, kn), (vq, vsc, vn)):
        g = np.array(jgather_view(pages, sc, bt))
        for b in range(B):
            if kv[b] > 0:
                g[b, kv[b] - 1] = new[b]
        views.append(jnp.asarray(g))
    want = jlayers.decode_attention(jnp.asarray(q), *views, jnp.asarray(kv),
                                    softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    as_is = ops.paged_decode_attention_int8(
        *map(_t, (q, kq, vq, ksc, vsc, bt, kv)), softcap=softcap)
    live = kv > 0
    assert not np.allclose(out.numpy()[live], as_is.numpy()[live], atol=1e-3)
    assert not out[~torch.from_numpy(live)].any()


def jgather_view(pages, scales, bt):
    """The reference engine's dense view of int8 pages, in f32."""
    return jref.gather_pages(
        jref.dequantize_pages_ref(jnp.asarray(pages), jnp.asarray(scales)),
        jnp.asarray(bt))


def test_paged_new_rows_need_int8_pages_and_each_other():
    rng = np.random.RandomState(3)
    q, kp, vp, bt, kv = map(_t, _paged(rng, 2, 4, 2, 16, 8, 5, 2))
    rows = torch.zeros((2, 2, 16))
    with pytest.raises(ValueError, match="int8"):
        ops.paged_decode_attention(q, kp, vp, bt, kv, k_new=rows, v_new=rows)
    (kq, ksc), (vq, vsc) = (ref.quantize_pages_ref(p) for p in (kp, vp))
    with pytest.raises(ValueError, match="neither"):
        ops.paged_decode_attention_int8(q, kq, vq, ksc, vsc, bt, kv,
                                        k_new=rows)


def test_int8_decode_error_within_documented_atol():
    """int8 pages from ``quantize_pages_ref`` keep the decode output within
    ``KV_INT8_DECODE_ATOL`` of the fp decode on the same pages (the
    reference's documented bound; the port keeps its own copy)."""
    assert ref.KV_INT8_DECODE_ATOL == jref.KV_INT8_DECODE_ATOL
    rng = np.random.RandomState(9)
    q, kp, vp, bt, kv = _paged(rng, 4, 16, 8, 128, 16, 20, 4,
                               lens=[1, 16, 40, 64])
    (kq, ksc), (vq, vsc) = (ref.quantize_pages_ref(_t(a)) for a in (kp, vp))
    out = ops.paged_decode_attention(_t(q), kq, vq, _t(bt), _t(kv),
                                     k_scales=ksc, v_scales=vsc)
    fp = ops.paged_decode_attention(*map(_t, (q, kp, vp, bt, kv)))
    err = float((out - fp).abs().max())
    assert 0 < err < ref.KV_INT8_DECODE_ATOL, err


@pytest.mark.parametrize("B,S,H,Kh,D,window,softcap,packed", [
    (2, 32, 4, 2, 16, 0, 0.0, False),
    (1, 37, 4, 1, 32, 0, 0.0, True),            # ragged S, packed with pad
    (2, 64, 8, 2, 16, 16, 0.0, False),          # sliding window
    (1, 48, 4, 4, 16, 0, 30.0, True),           # softcap + segments
    (3, 1, 2, 2, 8, 0, 0.0, False),             # S = 1
    (1, 37, 8, 4, 256, 16, 50.0, False),        # Gemma2 local: D 256
    (1, 33, 24, 2, 192, 0, 0.0, False),         # Nemotron: D 192, G 12
])
def test_flash_plain_matches_reference(B, S, H, Kh, D, window, softcap,
                                       packed):
    rng = np.random.RandomState(S * 10 + H)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, Kh, D).astype(np.float32)
    v = rng.randn(B, S, Kh, D).astype(np.float32)
    seg = _packed_seg(rng, B, S, 8) if packed else None
    out = ops.flash_attention(_t(q), _t(k), _t(v),
                              seg_ids=None if seg is None else _t(seg),
                              window=window, softcap=softcap)
    want = jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, softcap=softcap,
        seg_ids=None if seg is None else jnp.asarray(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,Dm,V,top_k,softcap,tied", [
    (4, 32, 1000, 1, 0.0, False),
    (2, 64, 515, 4, 0.0, True),
    (3, 16, 300, 8, 30.0, False),
])
def test_fused_sample_plain_matches_reference(B, Dm, V, top_k, softcap,
                                              tied):
    rng = np.random.RandomState(V)
    x = rng.randn(B, Dm).astype(np.float32)
    w = (rng.randn(Dm, V) / np.sqrt(Dm)).astype(np.float32)
    w[:, 7] = w[:, 400 % V] = w[:, 5]          # exact ties across blocks
    tw = _t(w.T.copy()).T if tied else _t(w)   # tied: a strided (Dm, V) view
    vals, idx, lse = ops.fused_sample(_t(x), tw, top_k=top_k,
                                      softcap=softcap)
    rv, ri, rl = jref.fused_sample_ref(jnp.asarray(x), jnp.asarray(w),
                                       top_k=top_k, softcap=softcap)
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), **TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(lse.numpy(), np.asarray(rl), **TOL)
    assert idx.dtype == torch.int32 and lse.shape == (B, 1)


# -- the split-KV decode's merge arithmetic -----------------------------------

@pytest.mark.parametrize("B,H,Kh,D,P,nb,split_rows,lens,softcap", [
    # splits of 24 rows end mid-page; 96-row tables: 4 splits, the slots
    # of 5 and 0 rows leave 3 and 4 of them empty
    (4, 8, 2, 32, 16, 6, 24, [5, 24, 50, 96], 0.0),
    (3, 4, 4, 16, 16, 6, 24, [0, 1, 25], 30.0),    # kv_len 0 and 1
    (2, 16, 2, 64, 8, 8, 16, [17, 64], 0.0),       # G = 8, page-aligned
])
def test_split_merge_matches_plain_and_reference(B, H, Kh, D, P, nb,
                                                 split_rows, lens, softcap):
    """The split-and-merge decode (each split's max, sum and unnormalised
    accumulator, then the merge the kernels' second pass does) equals the
    plain decode and the reference's, f32 within 1e-5; empty splits carry
    m = -inf and l = 0, and kv_len 0 gives zeros."""
    rng = np.random.RandomState(B * nb + D)
    q, kp, vp, bt, kv = _paged(rng, B, H, Kh, D, P, nb * B + 1, nb,
                               lens=lens)
    out, (m, l, acc) = ref.paged_decode_attention_split_ref(
        *map(_t, (q, kp, vp, bt, kv)), split_rows, softcap=softcap)
    assert m.shape == (B, H, -(-nb * P // split_rows))
    want = jref.paged_decode_attention_ref(
        *map(jnp.asarray, (q, kp, vp, bt, kv)), softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    plain = ref.paged_decode_attention_ref(*map(_t, (q, kp, vp, bt, kv)),
                                           softcap=softcap)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **TOL)
    starts = np.arange(m.shape[-1]) * split_rows
    empty = torch.from_numpy(starts[None, :] >= kv[:, None])[:, None]
    empty = empty.expand_as(m)
    assert bool(empty.any()) and bool((m[empty] == float("-inf")).all())
    assert not l[empty].any() and not acc[empty].any()
    assert bool(torch.isfinite(m[~empty]).all())
    assert not out[torch.from_numpy(kv == 0)].any()


@pytest.mark.parametrize("lens", [
    [33, 49, 1],        # new row the first row of a split (32, 48, 0)
    [32, 48, 16],       # new row the last row of a split
])
def test_split_merge_int8_new_row_on_split_edge(lens):
    """int8 pages with the slots' new rows on a split's first or last row:
    the split-and-merge decode equals the plain int8 decode and the
    reference engine's order (gather, dequantise, set row kv_len - 1,
    jnp decode), f32 within 1e-5."""
    B, H, Kh, D, P, nb, split_rows = 3, 8, 2, 32, 8, 8, 16
    rng = np.random.RandomState(sum(lens))
    q, kp, vp, bt, kv = _paged(rng, B, H, Kh, D, P, nb * B + 1, nb,
                               lens=lens)
    kn, vn = (3 * rng.randn(B, Kh, D).astype(np.float32) for _ in range(2))
    (kq, ksc), (vq, vsc) = _quantized(kp), _quantized(vp)
    out, _ = ref.paged_decode_attention_split_ref(
        *map(_t, (q, kq, vq, bt, kv)), split_rows, k_scales=_t(ksc),
        v_scales=_t(vsc), k_new=_t(kn), v_new=_t(vn))
    plain = ops.paged_decode_attention_int8(
        *map(_t, (q, kq, vq, ksc, vsc, bt, kv)), k_new=_t(kn), v_new=_t(vn))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **TOL)
    views = []
    for pages, sc, new in ((kq, ksc, kn), (vq, vsc, vn)):
        g = np.array(jgather_view(pages, sc, bt))
        g[np.arange(B), kv - 1] = new
        views.append(jnp.asarray(g))
    want = jlayers.decode_attention(jnp.asarray(q), *views, jnp.asarray(kv))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("S,lens,H,Kh,D,softcap", [
    (2048, [2000, 1500, 700, 1], 8, 4, 256, 50.0),     # Gemma2's heads
    (1024, [1000, 600, 37, 5], 96, 8, 192, 0.0),       # Nemotron's
    (1024, [1024, 900, 64, 2], 64, 8, 128, 0.0),       # Qwen1.5's
])
def test_decode_rule_holds_split_decode_and_sees_a_wrong_merge(S, lens, H, Kh,
                                                              D, softcap):
    """``chip_smoke.py`` holds the bf16 decode kernels to 2^-7*|want| +
    2^-5*rms(want[slot]) against the plain version, which rounds q/sqrt(D)
    and the weights to bf16.  The kernels' arithmetic (f32 split partials
    of 256 rows, the merge, the output rounded to bf16) stays inside it;
    the same with split 1's partials weighted 5% high falls outside, where
    a fixed 2e-2 lets it through."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(S + D)
    q = torch.randn((len(lens), H, D), generator=g).bfloat16()
    k, v = (torch.randn((len(lens), S, Kh, D), generator=g).bfloat16()
            for _ in range(2))
    kv = torch.tensor(lens, dtype=torch.int32)
    want = ref.ragged_decode_attention_ref(q, k, v, kv, softcap=softcap)
    m, l, acc = ref.decode_split_partials_ref(q, k, v, kv, 256,
                                              softcap=softcap)
    good = ref.merge_split_partials_ref(m, l, acc).bfloat16()
    excess, share, _ = cs.decode_excess(good, want)
    assert excess <= 0 and share < cs.DECODE_RMS
    l[:, :, 1] *= 1.05
    acc[:, :, 1] *= 1.05
    bad = ref.merge_split_partials_ref(m, l, acc).bfloat16()
    assert cs.decode_excess(bad, want)[0] > 0
    assert float((bad.float() - want.float()).abs().max()) <= 2e-2


# -- against the Pallas kernels in interpret mode -----------------------------

def test_flash_plain_matches_pallas_interpret():
    rng = np.random.RandomState(3)
    B, S, H, Kh, D = 2, 32, 4, 2, 16
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, Kh, D).astype(np.float32)
    v = rng.randn(B, S, Kh, D).astype(np.float32)
    seg = _packed_seg(rng, B, S, 8)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), seg_ids=jnp.asarray(seg),
                                block_q=16, block_k=16)
    out = ops.flash_attention(_t(q), _t(k), _t(v), seg_ids=_t(seg))
    real = seg >= 0                             # pad rows are garbage
    np.testing.assert_allclose(out.numpy()[real], np.asarray(want)[real],
                               **TOL)


def test_paged_decode_plain_matches_pallas_interpret():
    rng = np.random.RandomState(4)
    q, kp, vp, bt, kv = _paged(rng, 3, 4, 2, 32, 16, 6, 3, lens=[1, 20, 48])
    want = jops.paged_decode_attention(*map(jnp.asarray, (q, kp, vp, bt, kv)))
    out = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(kv))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,block_k,lens,softcap", [
    (64, 64, [0, 1, 37, 64], 0.0),              # block_k = S
    (48, 16, [5, 16, 48, 33], 20.0),            # 16-row blocks, skipped
])
def test_ragged_decode_plain_matches_pallas_interpret(S, block_k, lens,
                                                      softcap):
    """The Pallas kernel asserts S % block_k == 0, so its blocks are S or
    16 rows here; the plain version takes any S."""
    rng = np.random.RandomState(S)
    q, k, v, kv = _dense(rng, 4, S, 8, 2, 32, lens)
    want = jops.ragged_decode_attention(*map(jnp.asarray, (q, k, v, kv)),
                                        block_k=block_k, softcap=softcap)
    out = ops.ragged_decode_attention(*map(_t, (q, k, v, kv)),
                                      softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_paged_int8_plain_matches_pallas_interpret():
    rng = np.random.RandomState(10)
    q, kp, vp, bt, kv = _paged(rng, 3, 4, 2, 32, 16, 6, 3, lens=[1, 20, 48])
    (kq, ksc), (vq, vsc) = _quantized(kp), _quantized(vp)
    want = jops.paged_decode_attention_int8(
        *map(jnp.asarray, (q, kq, vq, ksc, vsc, bt, kv)))
    out = ops.paged_decode_attention_int8(
        *map(_t, (q, kq, vq, ksc, vsc, bt, kv)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_fused_sample_plain_matches_pallas_interpret():
    rng = np.random.RandomState(5)
    B, Dm, V = 2, 16, 300
    x = rng.randn(B, Dm).astype(np.float32)
    w = (rng.randn(Dm, V) / 4).astype(np.float32)
    w[:, 290] = w[:, 3] = w[:, 140] = 1.0       # a tie across vocab blocks
    x[:, :] = np.abs(x)
    vals, idx, lse = jops.fused_sample(jnp.asarray(x), jnp.asarray(w),
                                       top_k=4, block_v=128)
    tv, ti, tl = ops.fused_sample(_t(x), _t(w), top_k=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    assert ti[0, :3].tolist() == [3, 140, 290]
    np.testing.assert_allclose(tv.numpy(), np.asarray(vals), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(lse), **TOL)


# -- the CUDA wrappers never fall back ----------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_paged_decode_window_on_device_raises():
    """The decode kernel has no window: on a non-CPU tensor the wrapper
    raises instead of ignoring it (the CPU plain version applies it).
    The inputs mix meta and CPU tensors, which reach the CUDA path's
    checks (all-meta inputs take the plain version, for shapes)."""
    args = (_meta(2, 4, 64), _meta(5, 16, 2, 64), _meta(5, 16, 2, 64),
            _meta(2, 3, dtype=torch.int32), torch.ones(2, dtype=torch.int32))
    before = ops.launch_counts()
    with pytest.raises(NotImplementedError, match="window"):
        ops.paged_decode_attention(*args, window=8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(*args)
    assert ops.launch_counts() == before


def test_ragged_window_and_int8_scales_on_device_raise():
    # meta and CPU inputs mixed: the CUDA path's checks, as above
    q, kc = _meta(2, 4, 64), _meta(2, 40, 2, 64)
    kv = torch.ones(2, dtype=torch.int32)
    pages = _meta(5, 16, 2, 64, dtype=torch.int8)
    bt = _meta(2, 3, dtype=torch.int32)
    sc = _meta(5)
    before = ops.launch_counts()
    with pytest.raises(NotImplementedError, match="window"):
        ops.ragged_decode_attention(q, kc, kc, kv, window=8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ragged_decode_attention(q, kc, kc, kv)
    with pytest.raises(NotImplementedError, match="window"):
        ops.paged_decode_attention_int8(q, pages, pages, sc, sc, bt, kv,
                                        window=8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention_int8(q, pages, pages, sc, sc, bt, kv)
    with pytest.raises(ValueError, match="neither"):  # one scale plane
        ops.paged_decode_attention(q, pages, pages, bt, kv, k_scales=sc)
    assert ops.launch_counts() == before


def test_wrappers_refuse_non_cuda_devices():
    # mixed CPU and meta inputs are neither CPU tensors nor meta tensors
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(_meta(1, 8, 4, 64), torch.zeros(1, 8, 2, 64),
                            _meta(1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_sample(torch.zeros(2, 16), _meta(16, 40))
    # all-meta inputs (the launch path's fit report) take the plain
    # version: shapes only, no launch
    ops.reset_launch_counts()
    out = ops.flash_attention(_meta(1, 8, 4, 64), _meta(1, 8, 2, 64),
                              _meta(1, 8, 2, 64))
    assert out.device.type == "meta" and tuple(out.shape) == (1, 8, 4, 64)
    vals, idx, lse = ops.fused_sample(_meta(2, 16), _meta(16, 40))
    assert vals.device.type == "meta" and tuple(idx.shape) == (2, 1)
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("S,window,softcap,packed", [
    (100, 0, 0.0, False), (300, 40, 30.0, False), (257, 0, 0.0, True),
    (2100, 0, 0.0, False)])
def test_flash_rows_plain_is_full_attention_by_query_blocks(S, window,
                                                            softcap, packed):
    """``flash_attention_rows_ref`` (what chip_smoke holds the kernel to)
    is ``full_attention``'s arithmetic at every length, 128 queries at a
    time: equal to it within f32 sum order (1e-6)."""
    from repro_torch.models import layers as L
    rng = np.random.RandomState(S)
    q, k, v = (_t(rng.randn(2, S, h, 64).astype(np.float32))
               for h in (8, 4, 4))
    seg = _t(_packed_seg(rng, 2, S, 8)) if packed else None
    got = ref.flash_attention_rows_ref(q, k, v, window=window,
                                       softcap=softcap, seg_ids=seg,
                                       rows=128)
    want = L.full_attention(q, k, v, window=window, softcap=softcap,
                            seg_q=seg, seg_k=seg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_plain_path_counts_no_launch():
    rng = np.random.RandomState(6)
    ops.reset_launch_counts()
    ops.fused_sample(_t(rng.randn(2, 8).astype(np.float32)),
                     _t(rng.randn(8, 20).astype(np.float32)))
    ops.ragged_decode_attention(*map(_t, _dense(rng, 1, 8, 2, 1, 8, [3])))
    assert ops.launch_counts() == {"paged_decode_attention": 0,
                                   "paged_decode_attention_int8": 0,
                                   "ragged_decode_attention": 0,
                                   "flash_attention": 0, "fused_sample": 0}


def test_build_names_libraries_by_source_hash():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        path = build.lib_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
