"""The port's CUDA wrappers refuse what their kernels do not take: the
paged, dense (ragged) and int8-page decode kernels (an int8 call without
the slots' new rows included), and flash prefill (a base off the 16-byte
grid its TMA copies need); the bf16 flash kernel around its tile edges
and the wide heads against the plain versions.

Marked ``gpu``; skips where no CUDA device is present (the kernels have no
CPU mode).  Imports neither JAX nor the reference package, so it runs on
the card's host:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The kernels' results against their plain versions are checked on the card
in one place, ``chip_smoke.py`` (``--phase kernels``), with the tolerance
stated beside each case.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_wrappers_raise_on_what_kernels_do_not_take(dev):
    q = torch.zeros((2, 4, 80), device=dev)     # D = 80: not instantiated
    pages = torch.zeros((3, 16, 2, 80), device=dev)
    bt = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    kv = torch.ones((2,), dtype=torch.int32, device=dev)
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, pages, pages, bt, kv)
    with pytest.raises(ValueError):              # int64 block tables
        ops.paged_decode_attention(q[..., :64], pages[..., :64],
                                   pages[..., :64], bt.long(), kv)
    with pytest.raises(NotImplementedError):
        ops.paged_decode_attention(q[..., :64], pages[..., :64],
                                   pages[..., :64], bt, kv, window=4)
    with pytest.raises(ValueError):              # mixed dtypes
        ops.flash_attention(torch.zeros((1, 4, 2, 64), device=dev),
                            torch.zeros((1, 4, 2, 64), device=dev,
                                        dtype=torch.bfloat16),
                            torch.zeros((1, 4, 2, 64), device=dev))
    assert ops.launch_counts() == before


def test_dense_and_int8_decode_wrappers_raise_on_what_kernels_do_not_take(
        dev):
    q = torch.zeros((2, 4, 64), device=dev)
    kc = torch.zeros((2, 40, 2, 64), device=dev)
    kv = torch.ones((2,), dtype=torch.int32, device=dev)
    pages = torch.zeros((3, 16, 2, 64), dtype=torch.int8, device=dev)
    sc = torch.ones((3,), device=dev)
    bt = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    rows = torch.zeros((2, 2, 64), device=dev)
    new = dict(k_new=rows, v_new=rows)
    before = ops.launch_counts()
    cases = [
        # dense: D = 80, G = 5, bf16 cache under f32 q, int64 kv_len,
        # a non-contiguous cache, a window
        (ValueError, lambda: ops.ragged_decode_attention(
            torch.zeros((2, 4, 80), device=dev),
            torch.zeros((2, 40, 2, 80), device=dev),
            torch.zeros((2, 40, 2, 80), device=dev), kv)),
        (ValueError, lambda: ops.ragged_decode_attention(
            torch.zeros((2, 10, 64), device=dev), kc, kc, kv)),
        (ValueError, lambda: ops.ragged_decode_attention(
            q, kc.bfloat16(), kc.bfloat16(), kv)),
        (ValueError, lambda: ops.ragged_decode_attention(q, kc, kc,
                                                         kv.long())),
        (ValueError, lambda: ops.ragged_decode_attention(
            q, kc.transpose(1, 2).contiguous().transpose(1, 2), kc, kv)),
        (NotImplementedError, lambda: ops.ragged_decode_attention(
            q, kc, kc, kv, window=4)),
        # int8 pages (with valid new rows unless said): no scales, f64
        # scales, wrong scale length, int8 q, fp pages with scales, a
        # window, new rows of the wrong shape or dtype
        (ValueError, lambda: ops.paged_decode_attention(q, pages, pages, bt,
                                                        kv)),
        (ValueError, lambda: ops.paged_decode_attention_int8(
            q, pages, pages, sc.double(), sc.double(), bt, kv, **new)),
        (ValueError, lambda: ops.paged_decode_attention_int8(
            q, pages, pages, sc[:2], sc[:2], bt, kv, **new)),
        (ValueError, lambda: ops.paged_decode_attention_int8(
            q.to(torch.int8), pages, pages, sc, sc, bt, kv, **new)),
        (ValueError, lambda: ops.paged_decode_attention_int8(
            q, pages.float(), pages.float(), sc, sc, bt, kv, **new)),
        (NotImplementedError, lambda: ops.paged_decode_attention_int8(
            q, pages, pages, sc, sc, bt, kv, window=4, **new)),
        (ValueError, lambda: ops.paged_decode_attention_int8(
            q, pages, pages, sc, sc, bt, kv, k_new=rows[:, :1],
            v_new=rows[:, :1])),
        (ValueError, lambda: ops.paged_decode_attention_int8(
            q, pages, pages, sc, sc, bt, kv, k_new=rows.bfloat16(),
            v_new=rows.bfloat16())),
    ]
    for exc, call in cases:
        with pytest.raises(exc):
            call()
    assert ops.launch_counts() == before


def test_int8_decode_on_cuda_needs_the_new_rows(dev):
    """The int8 kernel reads each slot's new row unquantised (the
    reference's order); without them a CUDA call raises instead of
    reading the stale page row, while the CPU plain version reads the
    pool as it is."""
    q = torch.zeros((2, 4, 64), device=dev)
    pages = torch.zeros((3, 16, 2, 64), dtype=torch.int8, device=dev)
    sc = torch.ones((3,), device=dev)
    bt = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    kv = torch.ones((2,), dtype=torch.int32, device=dev)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="new rows"):
        ops.paged_decode_attention_int8(q, pages, pages, sc, sc, bt, kv)
    assert ops.launch_counts() == before
    out = ops.paged_decode_attention_int8(
        q.cpu(), pages.cpu(), pages.cpu(), sc.cpu(), sc.cpu(), bt.cpu(),
        kv.cpu())
    assert out.device.type == "cpu" and not out.any()


def _decode_excess(got, want):
    """``chip_smoke.py``'s bf16 decode rule: <= 0 passes."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.decode_excess(got, want)[0]


def _bf16(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).bfloat16()


def test_wide_head_kernels_match_their_plain_versions(dev):
    """The kernels at the heads of Gemma2-2B (D 256, G 2, softcap 50, a
    window below a tile) and Nemotron-4-340B (D 192, G 12), and the fused
    head with x streamed (Dm 8192): against the plain versions with
    ``chip_smoke.py``'s bf16 tolerances (flash: 1e-3 + 2^-7 |want| + 2^-9
    attn(|v|); decode 2^-7 |want| + 2^-5 rms(want[slot]); fused head 1e-3
    on values and logsumexp)."""
    from repro_torch.kernels import ref
    for B, S, H, Kh, D, win, cap in ((2, 100, 8, 4, 256, 20, 50.0),
                                     (1, 33, 24, 2, 192, 0, 0.0)):
        q, k, v = (_bf16(dev, B, S, h, D, seed=i)
                   for i, h in enumerate((H, Kh, Kh)))
        out = ops.flash_attention(q, k, v, window=win, softcap=cap).float()
        want = ref.flash_attention_ref(q, k, v, window=win,
                                       softcap=cap).float()
        wabs = ref.flash_attention_ref(q, k, v.abs(), window=win,
                                       softcap=cap).float()
        assert float(((out - want).abs() - 2.0 ** -7 * want.abs()
                      - 2.0 ** -9 * wabs).max()) <= 1e-3
    lens = torch.tensor([0, 17, 300, 299], dtype=torch.int32, device=dev)
    q = _bf16(dev, 4, 8, 256, seed=3)
    kc, vc = _bf16(dev, 4, 300, 4, 256, seed=4), _bf16(dev, 4, 300, 4, 256,
                                                       seed=5)
    got = ops.ragged_decode_attention(q, kc, vc, lens, softcap=50.0)
    want = ref.ragged_decode_attention_ref(q, kc, vc, lens, softcap=50.0)
    assert _decode_excess(got, want) <= 0
    assert not got[0].any()
    q = _bf16(dev, 2, 96, 192, seed=6)
    kp, vp = _bf16(dev, 40, 16, 8, 192, seed=7), _bf16(dev, 40, 16, 8, 192,
                                                       seed=8)
    bt = torch.arange(1, 39, dtype=torch.int32, device=dev)[:38].view(2, 19)
    lens = torch.tensor([257, 300], dtype=torch.int32, device=dev)
    got = ops.paged_decode_attention(q, kp, vp, bt, lens)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, lens)
    assert _decode_excess(got, want) <= 0
    x, w = _bf16(dev, 17, 8192, seed=9), _bf16(dev, 8192, 3000, seed=10) / 90
    vals, idx, lse = ops.fused_sample(x, w, top_k=4)
    rv, _, rl = ref.fused_sample_ref(x, w, top_k=4)
    assert float((vals - rv).abs().max()) <= 1e-3
    assert float((lse - rl).abs().max()) <= 1e-3


FLASH_EDGE_S = (1, 63, 64, 65, 127, 128, 129, 255, 256, 257)


@pytest.mark.parametrize("D", (64, 96, 128, 192, 256))
def test_flash_s_edges_match_the_plain_version(dev, D):
    """bf16 flash around its 128-row query tiles and 64-key K/V tiles: S
    from 1 to 257, segments (with a -1 pad
    tail), a window and softcap in turn and together, G 1, 4, 12 and 16,
    against ``ref.flash_attention_ref`` with the tolerance of
    ``test_wide_head_kernels_match_their_plain_versions``."""
    from repro_torch.kernels import ref
    mixes = ((False, 0, 0.0), (True, 0, 0.0), (False, 40, 0.0),
             (False, 0, 30.0), (True, 40, 30.0), (True, 0, 30.0),
             (False, 100, 30.0), (True, 100, 0.0))
    for i, S in enumerate(FLASH_EDGE_S):
        seg, win, cap = mixes[i % len(mixes)]
        G = (1, 4, 12, 16)[i % 4]
        q, k, v = (_bf16(dev, 2, S, h, D, seed=S + j)
                   for j, h in enumerate((2 * G, 2, 2)))
        s_ = None
        if seg:
            s_ = torch.zeros((2, S), dtype=torch.int32, device=dev)
            s_[:, S // 3:] = 1
            s_[:, S - S // 8:] = -1
        out = ops.flash_attention(q, k, v, seg_ids=s_, window=win,
                                  softcap=cap).float()
        want = ref.flash_attention_ref(q, k, v, window=win, softcap=cap,
                                       seg_ids=s_).float()
        wabs = ref.flash_attention_ref(q, k, v.abs(), window=win,
                                       softcap=cap, seg_ids=s_).float()
        assert float(((out - want).abs() - 2.0 ** -7 * want.abs()
                      - 2.0 ** -9 * wabs).max()) <= 1e-3, (S, seg, win, cap)


def test_flash_refuses_a_misaligned_base(dev):
    """The bf16 kernel's TMA copies need 16-byte aligned bases: a q two
    bytes off raises, and nothing launches."""
    q = _bf16(dev, 1, 64, 4, 128, seed=0)
    k, v = _bf16(dev, 1, 64, 2, 128, seed=1), _bf16(dev, 1, 64, 2, 128,
                                                    seed=2)
    qm = torch.empty(q.numel() + 8, dtype=q.dtype, device=dev)[
        1:1 + q.numel()].view(q.shape).copy_(q)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(qm, k, v)
    assert ops.launch_counts() == before


def test_wide_heads_stay_bf16_fp_only(dev):
    """D 192/256 exist in bf16 only: f32 raises, and so do int8 pages at
    Gemma2's D 256, G 2 (Gemma2 serves on the dense layout)."""
    before = ops.launch_counts()
    q = torch.zeros((2, 24, 192), device=dev)
    pages = torch.zeros((3, 16, 2, 192), device=dev)
    bt = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    kv = torch.ones((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, pages, pages, bt, kv)
    p8 = torch.zeros((3, 16, 2, 256), dtype=torch.int8, device=dev)
    sc = torch.ones((3,), device=dev)
    rows = torch.zeros((2, 2, 256), device=dev).bfloat16()
    with pytest.raises(ValueError):
        ops.paged_decode_attention_int8(
            torch.zeros((2, 4, 256), device=dev).bfloat16(), p8, p8, sc, sc,
            bt, kv, k_new=rows, v_new=rows)
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros((1, 4, 4, 256), device=dev),
                            torch.zeros((1, 4, 2, 256), device=dev),
                            torch.zeros((1, 4, 2, 256), device=dev))
    assert ops.launch_counts() == before


def test_moe_head_shapes_match_their_plain_versions(dev):
    """The decode kernels at Granite-MoE-3B-A800M's (D 64, G 3: fp pages,
    int8 pages and dense, f32 and bf16) and Qwen3-MoE-235B-A22B's heads
    (D 128, G 16, bf16: fp pages and dense), every head of a group
    checked (a G-3 row group reading the wrong weights for heads 1 and 2
    fails): f32 within 1e-4, int8 pages within 2e-2 of the plain int8
    version, bf16 by ``chip_smoke.py``'s decode rule."""
    from repro_torch.kernels import ref
    lens = torch.tensor([0, 1, 255, 256, 257, 300], dtype=torch.int32,
                        device=dev)
    B = lens.numel()
    bt = torch.arange(1, 1 + 19 * B, dtype=torch.int32,
                      device=dev).view(B, 19)
    for H, Kh, D, dtypes in ((24, 8, 64, (torch.float32, torch.bfloat16)),
                             (64, 4, 128, (torch.bfloat16,))):
        for dt in dtypes:
            q = _bf16(dev, B, H, D, seed=H).to(dt)
            kp = _bf16(dev, 1 + 19 * B, 16, Kh, D, seed=1).to(dt)
            vp = _bf16(dev, 1 + 19 * B, 16, Kh, D, seed=2).to(dt)
            kc = ref.gather_pages(kp, bt)
            vc = ref.gather_pages(vp, bt)
            for got, want in (
                    (ops.paged_decode_attention(q, kp, vp, bt, lens),
                     ref.paged_decode_attention_ref(q, kp, vp, bt, lens)),
                    (ops.ragged_decode_attention(q, kc, vc, lens),
                     ref.ragged_decode_attention_ref(q, kc, vc, lens))):
                assert not got[0].any()
                if dt == torch.float32:
                    assert float((got - want).abs().max()) <= 1e-4
                else:
                    assert _decode_excess(got, want) <= 0
            if D == 64:
                (k8, ks), (v8, vs) = (ref.quantize_pages_ref(p.float())
                                      for p in (kp, vp))
                new = [ref.dequantize_pages_ref(p8, sc)[
                    bt[torch.arange(B), ((lens - 1).clamp(min=0) // 16)
                       .long()].long(), ((lens - 1).clamp(min=0) % 16)
                    .long()].to(dt) for p8, sc in ((k8, ks), (v8, vs))]
                got = ops.paged_decode_attention_int8(
                    q, k8, v8, ks, vs, bt, lens, k_new=new[0], v_new=new[1])
                want = ref.paged_decode_attention_int8_ref(
                    q, k8, v8, ks, vs, bt, lens, k_new=new[0], v_new=new[1])
                assert float((got.float() - want.float()).abs().max()) \
                    <= 2e-2


def test_head_dim_96_matches_its_plain_versions(dev):
    """Phi-3-Vision-4.2B's heads (bf16, D 96, G 1): flash at S 33, 65 and
    97 (the 16-chunk pitch's rows 8-15 of a tile) with segments, the
    dense and paged decode at kv_len 0, 1, a page's last and first row and
    a split's edges, against the plain versions with ``chip_smoke.py``'s
    bf16 tolerances; f32 raises at D 96, on fp and int8 pages."""
    from repro_torch.kernels import ref
    for S, seg in ((33, False), (65, True), (97, False)):
        q, k, v = (_bf16(dev, 2, S, 4, 96, seed=i) for i in range(3))
        s_ = None
        if seg:
            s_ = torch.zeros((2, S), dtype=torch.int32, device=dev)
            s_[:, 32:] = 1
            s_[:, 60:] = -1
        out = ops.flash_attention(q, k, v, seg_ids=s_).float()
        want = ref.flash_attention_ref(q, k, v, seg_ids=s_).float()
        wabs = ref.flash_attention_ref(q, k, v.abs(), seg_ids=s_).float()
        assert float(((out - want).abs() - 2.0 ** -7 * want.abs()
                      - 2.0 ** -9 * wabs).max()) <= 1e-3
    lens = torch.tensor([0, 1, 16, 17, 255, 256, 257, 300],
                        dtype=torch.int32, device=dev)
    B = lens.numel()
    q = _bf16(dev, B, 4, 96, seed=3)
    kp, vp = (_bf16(dev, 1 + 19 * B, 16, 4, 96, seed=s) for s in (4, 5))
    bt = torch.arange(1, 1 + 19 * B, dtype=torch.int32,
                      device=dev).view(B, 19)
    kc, vc = ref.gather_pages(kp, bt), ref.gather_pages(vp, bt)
    for got, want in ((ops.paged_decode_attention(q, kp, vp, bt, lens),
                       ref.paged_decode_attention_ref(q, kp, vp, bt, lens)),
                      (ops.ragged_decode_attention(q, kc, vc, lens),
                       ref.ragged_decode_attention_ref(q, kc, vc, lens))):
        assert not got[0].any()
        assert _decode_excess(got, want) <= 0
    before = ops.launch_counts()
    p8, sc = kp.to(torch.int8), torch.ones((kp.shape[0],), device=dev)
    with pytest.raises(ValueError):
        ops.paged_decode_attention_int8(q.float(), p8, p8, sc, sc, bt, lens,
                                        k_new=q.float(), v_new=q.float())
    with pytest.raises(ValueError):
        ops.ragged_decode_attention(q.float(), kc.float(), vc.float(), lens)
    assert ops.launch_counts() == before


def test_dense_decode_kernel_with_kv_start_matches_its_plain_version(dev):
    """The dense decode kernel over rows [kv_start, kv_len) at Zamba2's
    head (D 64, G 1), bf16 and f32, S 700 (three splits of 256 rows):
    kv_start 0, one live row, on and inside a split's edge, kv_start ==
    kv_len and a slot with kv_len 0 (zeros); f32 within 1e-4, bf16 by
    ``chip_smoke.py``'s decode rule.  A bad kv_start raises."""
    from repro_torch.kernels import ref
    S, H = 700, 8
    lens = torch.tensor([600, 600, 600, 700, 300, 0], dtype=torch.int32,
                        device=dev)
    starts = torch.tensor([0, 599, 256, 300, 300, 0], dtype=torch.int32,
                          device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(13)
        q = torch.randn((6, H, 64), generator=g, device=dev).to(dtype)
        kc, vc = (torch.randn((6, S, H, 64), generator=g,
                              device=dev).to(dtype) for _ in range(2))
        got = ops.ragged_decode_attention(q, kc, vc, lens, kv_start=starts)
        want = ref.ragged_decode_attention_ref(q, kc, vc, lens,
                                               kv_start=starts)
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-4
        else:
            assert _decode_excess(got, want) <= 0
        assert not got[4:].any()
    with pytest.raises(ValueError):
        ops.ragged_decode_attention(q, kc, vc, lens, kv_start=starts.long())


def test_launch_path_long_shapes_match_their_plain_versions(dev):
    """The shapes the launch path gives the kernels for the first time:
    flash at Qwen3-0.6B's prefill_32k row (B 1, S 32,768, H 16, Kh 8,
    D 128), the dense decode over 33,280 rows (B 8, H 16, Kh 8, D 128;
    decode_32k) and over 524,800 rows at Gemma2-2B's global layers (B 1,
    H 8, Kh 4, D 256, softcap 50; long_500k: 2,050 splits a slot, each
    merged).  ``chip_smoke.py``'s bf16 tolerances, as above (flash against
    ``flash_attention_rows_ref``, full_attention's arithmetic at every
    length); slots with kv_len 0 give zeros."""
    from repro_torch.kernels import ref
    q, k, v = (_bf16(dev, 1, 32_768, h, 128, seed=i)
               for i, h in enumerate((16, 8, 8)))
    out = ops.flash_attention(q, k, v).float()
    want = ref.flash_attention_rows_ref(q, k, v).float()
    wabs = ref.flash_attention_rows_ref(q, k, v.abs()).float()
    assert float(((out - want).abs() - 2.0 ** -7 * want.abs()
                  - 2.0 ** -9 * wabs).max()) <= 1e-3
    del q, k, v, out, want, wabs
    for B, S, H, Kh, D, cap, lens in (
            (8, 33_280, 16, 8, 128, 0.0,
             [33_272, 0, 1, 256, 257, 33_280, 20_000, 33_279]),
            (1, 524_800, 8, 4, 256, 50.0, [524_792]),
            (2, 524_800, 8, 4, 256, 50.0, [0, 524_800])):
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = _bf16(dev, B, H, D, seed=S)
        kc, vc = (_bf16(dev, B, S, Kh, D, seed=S + i) for i in (1, 2))
        got = ops.ragged_decode_attention(q, kc, vc, kv, softcap=cap)
        want = ref.ragged_decode_attention_ref(q, kc, vc, kv, softcap=cap)
        assert _decode_excess(got, want) <= 0
        assert not got[kv == 0].any()
        del q, kc, vc, got, want


def _paged_case(dev, lens, H, Kh, D, nb, seed=0):
    """bf16 q and fp pages (a pool of its own for every call), block
    tables of distinct pages, and the int8 pages of the same rows with the
    slots' new rows."""
    from repro_torch.kernels import ref
    B = len(lens)
    q = _bf16(dev, B, H, D, seed=seed)
    kp, vp = (_bf16(dev, B * nb + 1, 16, Kh, D, seed=seed + i)
              for i in (1, 2))
    bt = (torch.randperm(B * nb, device=dev) + 1).to(torch.int32).view(B, nb)
    kv = torch.tensor(lens, dtype=torch.int32, device=dev)
    (k8, ks), (v8, vs) = ref.quantize_pages_ref(kp), ref.quantize_pages_ref(vp)
    new = dict(k_new=_bf16(dev, B, Kh, D, seed=seed + 3),
               v_new=_bf16(dev, B, Kh, D, seed=seed + 4))
    return (q, kp, vp, bt, kv), (q, k8, v8, ks, vs, bt, kv), new


def test_paged_decode_repeats_bit_for_bit(dev):
    """The bf16 paged kernel merges a slot split across CTAs in the kernel,
    through counters it sets back to 0: calls repeated on the same inputs
    give the same bits, fp and int8 pages."""
    fp, i8, new = _paged_case(dev, [2048, 700, 1, 0, 333], 16, 8, 128, 128)
    first = ops.paged_decode_attention(*fp)
    first8 = ops.paged_decode_attention_int8(*i8, **new)
    for _ in range(3):
        assert torch.equal(ops.paged_decode_attention(*fp), first)
        assert torch.equal(ops.paged_decode_attention_int8(*i8, **new),
                           first8)


def test_paged_decode_calls_of_other_shapes_share_the_workspace(dev):
    """Calls of other B, nb, heads and page dtypes in turn on one stream
    (one workspace, grown when a call needs more), each against the plain
    versions: fp pages at the decode rule, int8 pages within 2e-2."""
    from repro_torch.kernels import ref
    for i, (lens, H, Kh, D, nb) in enumerate((
            ([1500, 20, 900], 16, 8, 128, 128),
            ([17] * 40, 16, 8, 128, 2),
            ([600, 1], 64, 4, 128, 64),
            ([1000, 300, 5, 640], 96, 8, 192, 64),
            ([3000], 16, 8, 128, 256))):
        fp, i8, new = _paged_case(dev, lens, H, Kh, D, nb, seed=10 * i)
        got = ops.paged_decode_attention(*fp)
        assert _decode_excess(got, ref.paged_decode_attention_ref(*fp)) <= 0
        got8 = ops.paged_decode_attention_int8(*i8, **new)
        want8 = ref.paged_decode_attention_int8_ref(*i8, **new)
        assert float((got8.float() - want8.float()).abs().max()) <= 2e-2


def test_paged_decode_after_a_pool_is_reallocated(dev):
    """The wrapper keeps only a workspace per stream, nothing of a pool:
    a pool freed and made again (at another address, or the same one with
    other contents) is read as it is now."""
    from repro_torch.kernels import ref
    fp, _, _ = _paged_case(dev, [900, 40], 16, 8, 128, 64, seed=1)
    ops.paged_decode_attention(*fp)
    q, kp, vp, bt, kv = fp
    del fp, kp, vp
    torch.cuda.synchronize()
    kp2, vp2 = (_bf16(dev, 2 * 64 + 1, 16, 8, 128, seed=s) for s in (7, 8))
    got = ops.paged_decode_attention(q, kp2, vp2, bt, kv)
    assert _decode_excess(
        got, ref.paged_decode_attention_ref(q, kp2, vp2, bt, kv)) <= 0
    kp2.copy_(_bf16(dev, 2 * 64 + 1, 16, 8, 128, seed=9))
    got = ops.paged_decode_attention(q, kp2, vp2, bt, kv)
    assert _decode_excess(
        got, ref.paged_decode_attention_ref(q, kp2, vp2, bt, kv)) <= 0
