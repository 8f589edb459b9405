"""The port's CUDA wrappers refuse what their kernels do not take: the
paged, dense (ragged) and int8-page decode kernels (an int8 call without
the slots' new rows included), and flash prefill.

Marked ``gpu``; skips where no CUDA device is present (the kernels have no
CPU mode).  Imports neither JAX nor the reference package, so it runs on
the card's host:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The kernels' results against their plain versions are checked on the card
in one place, ``chip_smoke.py`` (``--phase kernels``), with the tolerance
stated beside each case.
"""
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
    q = torch.zeros((2, 4, 96), device=dev)     # D = 96: not instantiated
    pages = torch.zeros((3, 16, 2, 96), device=dev)
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
        # dense: D = 96, G = 3, bf16 cache under f32 q, int64 kv_len,
        # a non-contiguous cache, a window
        (ValueError, lambda: ops.ragged_decode_attention(
            torch.zeros((2, 4, 96), device=dev),
            torch.zeros((2, 40, 2, 96), device=dev),
            torch.zeros((2, 40, 2, 96), device=dev), kv)),
        (ValueError, lambda: ops.ragged_decode_attention(
            torch.zeros((2, 6, 64), device=dev), kc, kc, kv)),
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
