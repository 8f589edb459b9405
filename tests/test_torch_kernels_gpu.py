"""The port's CUDA wrappers refuse what their kernels do not take.

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
