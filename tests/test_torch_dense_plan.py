"""The bf16 dense decode kernel's plan (``csrc/dense_decode_hopper.cuh``),
through its plain twin ``ref.ragged_decode_work_plan``: every live row of
every (slot, KV head) is taken exactly once, the CTAs' shares differ by at
most one unit, no unit exists for a slot without live rows (``kv_len``
0, ``kv_start >= kv_len``), S 448 and 1,500 tails are covered, one slot
spreads over every CTA, the split pieces fit the workspace, and the
per-piece partials merged over the plan (``ref.ragged_decode_plan_ref``)
equal the JAX reference's dense decode in f32 within 1e-5: its Pallas
kernel in interpret mode where S is a multiple of its ``block_k``, its
plain decode otherwise (and with ``kv_start``, which the Pallas kernel
does not take).  No model: seconds."""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401
from proptest import cases, integers, lists, sampled_from
from repro.kernels import ragged_decode_attention as jkern
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import ref

# f32 on both sides; only the order of the sums differs (the plan's
# pieces merged by their maxima against one softmax over all rows)
TOL = dict(atol=1e-5, rtol=1e-5)


def _live(lens, starts, S):
    starts = starts or [0] * len(lens)
    return [(max(0, s), max(0, min(n, S) - max(0, s)))
            for n, s in zip(lens, starts)]


def _taken_rows(lens, starts, S, Kh, ctas, rows, group):
    """(b, kh, row) -> times the plan's pieces take the row."""
    _, pieces = ref.ragged_decode_work_plan(lens, starts, S, Kh, ctas, rows,
                                            group)
    live = _live(lens, starts, S)
    taken = Counter()
    for pc in pieces:
        s0, n = live[pc.b]
        for r in range(s0 + pc.lo * rows, s0 + min(pc.hi * rows, n)):
            taken[(pc.b, pc.kh, r)] += 1
    return taken, pieces


def _want_rows(lens, starts, S, Kh):
    return {(b, h, r) for b, (s0, n) in enumerate(_live(lens, starts, S))
            for h in range(Kh) for r in range(s0, s0 + n)}


@cases(max_examples=60, lens=lists(integers(0, 300), min_size=1,
                                   max_size=40),
       S=sampled_from([64, 200, 256, 448]), kh=sampled_from([1, 2, 4, 8]),
       group=sampled_from([1, 2, 4, 8]), rows=sampled_from([16, 32]),
       ctas=integers(1, 400), start_max=sampled_from([0, 50, 300]))
def test_plan_takes_every_live_row_of_every_kv_head_once(
        lens, S, kh, group, rows, ctas, start_max):
    group = min(group, kh)
    rng = np.random.RandomState(len(lens) + ctas)
    starts = rng.randint(0, start_max + 1, size=len(lens)).tolist()
    taken, pieces = _taken_rows(lens, starts, S, kh, ctas, rows, group)
    assert set(taken) == _want_rows(lens, starts, S, kh)
    assert set(taken.values()) <= {1}
    for pc in pieces:
        assert 0 <= pc.lo < pc.hi


@cases(max_examples=60, lens=lists(integers(0, 300), min_size=1,
                                   max_size=40),
       kh=sampled_from([1, 2, 4, 8]), rows=sampled_from([16, 32]),
       ctas=integers(1, 400))
def test_plan_shares_differ_by_at_most_one_unit(lens, kh, rows, ctas):
    shares, _ = ref.ragged_decode_work_plan(lens, None, 256, kh, ctas, rows)
    U = kh * sum(-(-min(n, 256) // rows) for n in lens)
    assert len(shares) == min(ctas, U)
    if shares:
        sizes = [u1 - u0 for u0, u1 in shares]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
        assert shares[0][0] == 0 and shares[-1][1] == U
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))


@pytest.mark.parametrize("lens,starts", [
    ([0, 0, 0], None),                          # kv_len 0 everywhere
    ([0, 37, 0, 5], [0, 37, 3, 9]),             # kv_start at and past kv_len
    ([600, 10, 900], [512, 10, 512]),           # kv_start at or past S
])
def test_no_unit_for_a_slot_without_live_rows(lens, starts):
    S, Kh = 512, 4
    shares, pieces = ref.ragged_decode_work_plan(lens, starts, S, Kh, 132,
                                                 16, 2)
    assert pieces == [] and shares == []


@pytest.mark.parametrize("S,rows", [(448, 16), (448, 32), (1500, 16),
                                    (1500, 32)])
def test_tails_of_s_448_and_1500(S, rows):
    """Whisper's self-attention cache (448 rows) and its cross K/V (1500
    rows, not a multiple of 16): every row up to S once, none past it,
    with kv_len at, below and past S."""
    lens, Kh = [S, S - 1, S + 7, 1, 0, S // 2 + 3], 12
    taken, pieces = _taken_rows(lens, None, S, Kh, 132, rows, 6)
    assert set(taken) == _want_rows(lens, None, S, Kh)
    assert set(taken.values()) <= {1}
    assert max(r for _, _, r in taken) == S - 1


@pytest.mark.parametrize("ctas,rows", [(132, 16), (132, 32), (7, 16)])
def test_one_slot_spreads_over_every_cta(ctas, rows):
    """long_500k's shape, cut: one slot, Kh 4 in one group of 4, every CTA
    takes a piece of it, and each piece's workspace slot is its CTA's."""
    shares, pieces = ref.ragged_decode_work_plan([20_000], None, 20_480, 4,
                                                 ctas, rows, 4)
    assert len(shares) == ctas
    assert {pc.cta for pc in pieces} == set(range(ctas))
    assert all(not pc.whole and pc.slot // 2 == pc.cta for pc in pieces)


@cases(max_examples=60, lens=lists(integers(0, 300), min_size=1,
                                   max_size=40),
       kh=sampled_from([1, 2, 4, 8]), group=sampled_from([1, 2, 4, 8]),
       ctas=integers(1, 400))
def test_plan_pieces_fit_the_workspace(lens, kh, group, ctas):
    """A split piece's partial sits in slot 2 c or 2 c + 1 of its CTA c:
    no two split pieces of one KV head share a slot."""
    group = min(group, kh)
    _, pieces = ref.ragged_decode_work_plan(lens, None, 300, kh, ctas, 16,
                                            group)
    split = [pc for pc in pieces if not pc.whole]
    assert all(pc.slot // 2 == pc.cta and 0 <= pc.slot < 2 * ctas
               for pc in split)
    assert set(Counter((pc.slot, pc.kh) for pc in split).values()) <= {1}


def _inputs(seed, B, S, Kh, G, D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Kh * G, D).astype(np.float32)
    k = rng.randn(B, S, Kh, D).astype(np.float32)
    v = rng.randn(B, S, Kh, D).astype(np.float32)
    return q, k, v


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_plan_merge_matches_the_pallas_kernel(softcap):
    """S 256, a multiple of the Pallas kernel's block_k 128 (interpret
    mode): kv_len 0, 1, a chunk's edges, past S, over 2 to 5 CTAs a slot."""
    S, Kh, G, D = 256, 2, 2, 32
    lens = np.asarray([0, 1, 16, 17, 256, 300, 100], np.int32)
    q, k, v = _inputs(3, len(lens), S, Kh, G, D)
    out, _, _ = ref.ragged_decode_plan_ref(
        *map(_t, (q, k, v, lens)), ctas=11, rows=16, group=2,
        softcap=softcap)
    want = jkern.ragged_decode_attention(
        *map(jnp.asarray, (q, k, v, lens)), softcap=softcap, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,rows,ctas", [(448, 16, 132), (1500, 32, 9),
                                         (300, 16, 50)])
def test_plan_merge_matches_the_jax_reference(S, rows, ctas):
    """S not a multiple of 128 (Whisper's 448 and 1500, and 300): the JAX
    reference's plain decode (``repro.kernels.ref``), softcap 30."""
    Kh, G, D = 4, 1, 32
    lens = np.asarray([S, S - 5, 0, 1, 33, S + 40], np.int32)
    q, k, v = _inputs(S, len(lens), S, Kh, G, D)
    out, _, _ = ref.ragged_decode_plan_ref(
        *map(_t, (q, k, v, lens)), ctas=ctas, rows=rows, group=2,
        softcap=30.0)
    want = jref.ragged_decode_attention_ref(
        *map(jnp.asarray, (q, k, v, lens)), softcap=30.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_plan_merge_with_kv_start_matches_the_jax_reference(softcap):
    """Left-padded slots (Zamba2's): kv_start 0, on and inside a chunk,
    one live row, at kv_len (zeros), past S, against the JAX reference's
    decode with ``kv_start`` (``repro.models.layers.decode_attention``)."""
    S, Kh, G, D = 200, 2, 3, 32
    lens = np.asarray([200, 150, 150, 90, 90, 250, 0], np.int32)
    starts = np.asarray([0, 32, 37, 89, 90, 199, 0], np.int32)
    q, k, v = _inputs(5, len(lens), S, Kh, G, D)
    out, _, _ = ref.ragged_decode_plan_ref(
        *map(_t, (q, k, v, lens)), ctas=13, rows=16, group=1,
        softcap=softcap, kv_start=_t(starts))
    want = jlayers.decode_attention(*map(jnp.asarray, (q, k, v, lens)),
                                    softcap=softcap,
                                    kv_start=jnp.asarray(starts))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    assert not out[4].any() and not out[6].any()
