"""Blockwise attention above ``FULL_ATTN_MAX_SEQ`` (2048), on the CPU.

* The port's ``forward`` at S = 2050 (one position past the switch, so
  both packages take their blockwise branch) against the reference's
  ``forward`` on the tiny f32 LM (d_model 64, 2 layers) with the
  reference's weights (``repro_torch.convert``): logits within
  ``FWD_TOL`` (1e-5; both are f32 and only the order of sums differs,
  logits of magnitude up to ~5).
* The port's ``blockwise_attention`` against its ``full_attention`` at
  S = 2050 (GQA, ragged edge of both block sizes): values within
  ``ATTN_TOL`` (1e-5) and the gradients of q, k and v within
  ``GRAD_TOL`` (1e-5); both are f32, and the online softmax only
  reorders the sums.
* The branch itself: at S = 2048 ``forward`` attends fully, above it
  blockwise, and the plain prefill (the flash wrapper on CPU tensors)
  switches at the same width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jbuild
from repro.rl.session import tiny_lm_config as jtiny
from repro_torch import convert
from repro_torch.configs.base import tiny_lm_config
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model

FWD_TOL = dict(atol=1e-5, rtol=0)
ATTN_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=1e-5, rtol=0)
S_LONG = TF.FULL_ATTN_MAX_SEQ + 2


def test_forward_above_the_switch_matches_reference():
    jcfg, tcfg = jtiny(61, d_model=64, layers=2), tiny_lm_config(
        61, d_model=64, layers=2)
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = build_model(tcfg, device="cpu")
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(0).randint(1, 61, size=(1, S_LONG))
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("window", [0, 300])
def test_blockwise_matches_full_attention_values_and_grads(window):
    rng = np.random.RandomState(1)
    shapes = [(1, S_LONG, 4, 16), (1, S_LONG, 2, 16), (1, S_LONG, 2, 16)]
    ins = [torch.tensor(rng.randn(*s).astype(np.float32), requires_grad=True)
           for s in shapes]
    w = torch.from_numpy(rng.randn(*shapes[0]).astype(np.float32))
    outs, grads = [], []
    for attend in (L.blockwise_attention, L.full_attention):
        o = attend(*ins, causal=True, window=window)
        outs.append(o.detach())
        grads.append(torch.autograd.grad((o * w).sum(), ins))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **ATTN_TOL)
    for g_block, g_full in zip(*grads):
        np.testing.assert_allclose(g_block.numpy(), g_full.numpy(),
                                   **GRAD_TOL)


def test_plain_paths_switch_at_the_reference_width(monkeypatch):
    calls = []
    for name in ("full_attention", "blockwise_attention"):
        fn = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    cfg = tiny_lm_config(11, d_model=16, layers=1, heads=2)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    for S, want in ((TF.FULL_ATTN_MAX_SEQ, "full_attention"),
                    (TF.FULL_ATTN_MAX_SEQ + 1, "blockwise_attention")):
        calls.clear()
        with torch.no_grad():
            model.forward(params, {"tokens": torch.ones((1, S), dtype=torch.long)})
        assert calls == [want]
        calls.clear()
        q = torch.zeros((1, S, 2, 8))
        R.flash_attention_ref(q, q[:, :, :1], q[:, :, :1])
        assert calls == [want]
