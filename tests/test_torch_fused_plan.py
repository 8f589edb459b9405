"""The bf16 fused head's plan (``repro_torch.kernels.fused_sample.plan``),
on the CPU, at every head of the registry (``configs/base.py``
``ARCH_IDS``: its (Dm, V) and whether it is tied), batch rows B in {1, 8,
16, 17, 32, 33, 64} and top-k in {1, 8, 16}:

* W is read once: one pass for every B up to 64 (more rows take one pass
  per 64, each a launch);
* the shared memory the kernel asks for fits the H100's 232,448 bytes a
  block, and the ring has as many stages as fit (at least 2, at most
  ``MAX_STAGES``);
* x streams at every head: each stage holds x's 64-column slice beside
  its W tile, so Dm sets no part of the plan;
* the grid covers every 128-row vocabulary tile, the CTAs' tile counts
  differ by at most one, and the workspace the wrapper requests holds one
  partial (max, sum, k values, k indices) per (row, CTA), in records of
  16 bytes' multiple.

The C entry recomputes the layout from the same arguments and refuses a
plan whose bytes differ; that check runs on the card (``chip_smoke.py``).
"""
import pytest

import torch_cpu  # noqa: F401
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.kernels import fused_sample as fsm

BS = (1, 8, 16, 17, 32, 33, 64)
KS = (1, 8, 16)
W_TILE = fsm.VOCAB_TILE * fsm.D_STAGE * 2     # bytes of W a stage


def _head(arch):
    cfg = get_config(arch)
    return cfg.d_model, cfg.vocab_size, cfg.tie_embeddings


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_reads_w_once_and_fits(arch, B, k):
    Dm, V, _ = _head(arch)
    p = fsm.plan(B, Dm, V, k)
    assert p.passes == 1 and p.rows == B
    assert p.n % 8 == 0 and B <= p.n < B + 8 and p.n <= fsm.MAX_ROWS
    assert p.smem == fsm.head_smem_bytes(p.n, k, p.stages)
    assert p.smem <= fsm.SMEM_MAX
    assert 2 <= p.stages <= fsm.MAX_STAGES
    # as many stages as fit
    assert (p.stages == fsm.MAX_STAGES
            or fsm.head_smem_bytes(p.n, k, p.stages + 1) > fsm.SMEM_MAX)
    # the ring holds a W tile and x's slice (n rows x 128 bytes) a stage
    assert p.smem > p.stages * (W_TILE + p.n * 128)

    tiles = -(-V // fsm.VOCAB_TILE)
    assert 1 <= p.grid <= min(fsm.H100_SMS, tiles)
    per_cta = [len(range(c, tiles, p.grid)) for c in range(p.grid)]
    assert sum(per_cta) == tiles and max(per_cta) - min(per_cta) <= 1
    assert p.ws_floats >= B * p.grid * (2 + 2 * k)
    assert p.ws_floats == B * fsm.record_floats(p.grid, k)
    assert fsm.record_floats(p.grid, k) % 4 == 0     # 16-byte records


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rows_past_64_take_one_pass_each(arch):
    Dm, V, _ = _head(arch)
    for B, passes in ((65, 2), (128, 2), (129, 3)):
        p = fsm.plan(B, Dm, V, 1)
        assert p.passes == passes and p.rows == fsm.MAX_ROWS
        assert p.ws_floats >= fsm.MAX_ROWS * p.grid * 4


def test_x_streams_at_every_head():
    """A stage costs its W tile, x's slice and its two barriers, at every
    n; and the registry's heads at B 32, k 1 get the plan of any other
    width of the same vocabulary: Dm sets no part of it."""
    for n in range(8, fsm.MAX_ROWS + 1, 8):
        assert (fsm.head_smem_bytes(n, 16, 3) - fsm.head_smem_bytes(n, 16, 2)
                == W_TILE + n * 128 + 16)
    for arch in ARCH_IDS:
        Dm, V, _ = _head(arch)
        assert fsm.plan(32, Dm, V, 1) == fsm.plan(32, 64, V, 1), arch


def test_a_smaller_card_gets_a_smaller_grid():
    p = fsm.plan(32, 1024, 151936, 1, sms=66)
    assert p.grid == 66 and p.ws_floats == 32 * 66 * 4 == 32 * 264
    assert fsm.plan(2, 64, 300, 1).grid == 3     # three tiles only
