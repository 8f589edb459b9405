"""The bf16 paged decode kernel's plan (``csrc/paged_decode_hopper.cuh``),
through its plain twin ``ref.paged_decode_work_plan``: every (slot, KV
head, page) is taken exactly once, the CTAs' shares differ by at most one
unit, the split pieces fit the workspace, and the per-piece partials merged
over the plan equal the JAX reference's paged decode (fp and int8 pages)
in f32 within 1e-5, and the port's plain decodes on further plans (the
int8 new row on a piece's edge among them).  No model, no jit: a few
seconds."""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proptest import cases, integers, lists, sampled_from
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import ref

P = 16                                   # the kernel's page rows
TOL = dict(atol=1e-5, rtol=1e-5)


def _plan(lens, nb, Kh, ctas, group):
    return ref.paged_decode_work_plan(lens, P, nb, Kh, ctas, group)


def _units(lens, nb):
    return [-(-max(0, min(n, nb * P)) // P) for n in lens]


@cases(max_examples=60, lens=lists(integers(0, 300), min_size=1,
                                   max_size=40),
       nb=integers(1, 20), kh=sampled_from([1, 2, 4, 8]),
       group=sampled_from([1, 2, 4, 8]), ctas=integers(1, 400))
def test_plan_takes_every_page_of_every_kv_head_once(lens, nb, kh, group,
                                                     ctas):
    group = min(group, kh)
    shares, pieces = _plan(lens, nb, kh, ctas, group)
    taken = Counter((pc.b, pc.kh, pg) for pc in pieces
                    for pg in range(pc.lo, pc.hi))
    want = {(b, h, pg) for b, npg in enumerate(_units(lens, nb))
            for h in range(kh) for pg in range(npg)}
    assert set(taken) == want and set(taken.values()) <= {1}
    # a piece lies inside its CTA's share, in unit order
    for pc in pieces:
        assert 0 <= pc.lo < pc.hi and pc.cta < len(shares)


@cases(max_examples=60, lens=lists(integers(0, 300), min_size=1,
                                   max_size=40),
       nb=integers(1, 20), kh=sampled_from([1, 2, 4, 8]),
       ctas=integers(1, 400))
def test_plan_shares_differ_by_at_most_one_unit(lens, nb, kh, ctas):
    shares, _ = _plan(lens, nb, kh, ctas, 1)
    U = kh * sum(_units(lens, nb))
    assert len(shares) == min(ctas, U)
    if shares:
        sizes = [u1 - u0 for u0, u1 in shares]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
        assert shares[0][0] == 0 and shares[-1][1] == U
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))


@cases(max_examples=60, lens=lists(integers(0, 300), min_size=1,
                                   max_size=40),
       nb=integers(1, 20), kh=sampled_from([1, 2, 4, 8]),
       group=sampled_from([1, 2, 4, 8]), ctas=integers(1, 400))
def test_plan_pieces_fit_the_workspace(lens, nb, kh, group, ctas):
    """A split piece's partial sits in slot 2 c or 2 c + 1 of its CTA c
    (one per KV head of the group): slots below 2 C, no two split pieces
    of one KV head in one slot, and at most C + (items) pieces a KV head,
    an item being a slot's KV head."""
    group = min(group, kh)
    _, pieces = _plan(lens, nb, kh, ctas, group)
    split = [pc for pc in pieces if not pc.whole]
    assert all(0 <= pc.slot < 2 * ctas for pc in split)
    assert all(pc.slot // 2 == pc.cta for pc in split)
    keys = Counter((pc.slot, pc.kh) for pc in split)
    assert set(keys.values()) <= {1}
    items = sum(1 for n in _units(lens, nb) if n)
    per_kh = Counter(pc.kh for pc in pieces)
    assert all(n <= min(ctas, kh * sum(_units(lens, nb))) + items
               for n in per_kh.values())


def _inputs(seed, lens, Kh, G, D, nb):
    rng = np.random.RandomState(seed)
    B, H = len(lens), Kh * G
    N = B * nb + 1
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(N, P, Kh, D).astype(np.float32)
    vp = rng.randn(N, P, Kh, D).astype(np.float32)
    bt = (rng.permutation(N - 1)[:B * nb].reshape(B, nb) + 1).astype(np.int32)
    kn, vn = (rng.randn(B, Kh, D).astype(np.float32) for _ in range(2))
    return q, kp, vp, bt, np.asarray(lens, np.int32), kn, vn


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _jax_int8(q, kq, vq, ks, vs, bt, kv, kn, vn):
    """The reference engine's int8 read: the dequantised view with each
    slot's new row in place of row len - 1, then the jnp decode."""
    views = []
    for pages, sc, new in ((kq, ks, kn), (vq, vs, vn)):
        g = np.array(jref.gather_pages(
            jref.dequantize_pages_ref(jnp.asarray(pages), jnp.asarray(sc)),
            jnp.asarray(bt)))
        live = kv > 0
        g[np.arange(len(kv))[live], kv[live] - 1] = new[live]
        views.append(jnp.asarray(g))
    return np.asarray(jlayers.decode_attention(jnp.asarray(q), *views,
                                               jnp.asarray(kv)))


def _int8(kp, vp):
    (kq, ks), (vq, vs) = (map(np.asarray, jref.quantize_pages_ref(
        jnp.asarray(x))) for x in (kp, vp))
    return kq, ks, vq, vs


@pytest.mark.parametrize("int8", [False, True])
def test_plan_merge_matches_the_jax_reference(int8):
    """The plan's merged partials against the JAX reference's paged decode
    (and the reference engine's int8 read), with kv_len 0 and 1, a page's
    edges, and more CTAs than pages of some slot."""
    lens, Kh, G, nb, ctas, group = [0, 1, 17, 96, 50, 33], 2, 2, 7, 5, 2
    q, kp, vp, bt, kv, kn, vn = _inputs(7, lens, Kh, G, 32, nb)
    if not int8:
        out, _, _ = ref.paged_decode_plan_ref(*map(_t, (q, kp, vp, bt, kv)),
                                              ctas, group)
        want = jref.paged_decode_attention_ref(*map(jnp.asarray,
                                                    (q, kp, vp, bt, kv)))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
        return
    kq, ks, vq, vs = _int8(kp, vp)
    out, _, _ = ref.paged_decode_plan_ref(
        *map(_t, (q, kq, vq, bt, kv)), ctas, group, k_scales=_t(ks),
        v_scales=_t(vs), k_new=_t(kn), v_new=_t(vn))
    np.testing.assert_allclose(
        out.numpy(), _jax_int8(q, kq, vq, ks, vs, bt, kv, kn, vn), **TOL)


@pytest.mark.parametrize("lens,Kh,G,nb,ctas,group", [
    ([250, 3, 160, 16, 17], 4, 3, 16, 7, 4),      # Granite's G 3
    ([256], 2, 1, 16, 9, 1),                      # one slot over 9 CTAs
    ([16] * 12 + [40], 2, 2, 3, 3, 2),            # one-page slots, a share
    ([200, 130, 77], 1, 4, 13, 50, 1),            # more CTAs than items
])
@pytest.mark.parametrize("int8", [False, True])
def test_plan_merge_matches_the_plain_decode(lens, Kh, G, nb, ctas, group,
                                             int8):
    """Further plans against the port's plain decodes (held to the JAX
    reference by ``test_torch_kernels.py``): Granite's G 3 in groups of 4
    KV heads, one slot over 9 CTAs, one-page slots sharing a CTA, more
    CTAs than items."""
    q, kp, vp, bt, kv, kn, vn = _inputs(sum(lens) + ctas, lens, Kh, G, 32, nb)
    if not int8:
        args = tuple(map(_t, (q, kp, vp, bt, kv)))
        out, _, _ = ref.paged_decode_plan_ref(*args, ctas, group)
        want = ref.paged_decode_attention_ref(*args)
    else:
        kq, ks, vq, vs = _int8(kp, vp)
        new = dict(k_new=_t(kn), v_new=_t(vn))
        out, _, _ = ref.paged_decode_plan_ref(
            *map(_t, (q, kq, vq, bt, kv)), ctas, group, k_scales=_t(ks),
            v_scales=_t(vs), **new)
        want = ref.paged_decode_attention_int8_ref(
            *map(_t, (q, kq, vq, ks, vs, bt, kv)), **new)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("edge", ["first", "last"])
def test_plan_new_row_on_a_piece_edge(edge):
    """int8: the new row (row len - 1) on the first unit of a CTA's share
    (the item's last page opens a piece, and the new row is that page's
    first row) or on its last unit (the item ends where the share does);
    the merged result equals the plain int8 decode."""
    Kh, G, nb = 2, 2, 8
    found = None
    for ctas in range(2, 40):
        for n0 in range(17, 120, 16):              # row n0 - 1 opens a page
            lens = [n0, 40, 70]
            shares, pieces = _plan(lens, nb, Kh, ctas, 1)
            npg = _units(lens, nb)
            for pc in pieces:
                item0 = Kh * sum(npg[:pc.b]) + pc.kh * npg[pc.b]
                starts = pc.lo == npg[pc.b] - 1 and not pc.whole
                ends = (pc.hi == npg[pc.b] and not pc.whole
                        and item0 + npg[pc.b] == shares[pc.cta][1])
                if (edge == "first" and starts and pc.b == 0) or \
                        (edge == "last" and ends):
                    found = (lens, ctas)
                    break
            if found:
                break
        if found:
            break
    assert found, f"no plan puts the new row on a share's {edge} unit"
    lens, ctas = found
    q, kp, vp, bt, kv, kn, vn = _inputs(ctas, lens, Kh, G, 32, nb)
    kq, ks, vq, vs = _int8(kp, vp)
    new = dict(k_new=_t(kn), v_new=_t(vn))
    out, _, _ = ref.paged_decode_plan_ref(
        *map(_t, (q, kq, vq, bt, kv)), ctas, 1, k_scales=_t(ks),
        v_scales=_t(vs), **new)
    want = ref.paged_decode_attention_int8_ref(
        *map(_t, (q, kq, vq, ks, vs, bt, kv)), **new)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
