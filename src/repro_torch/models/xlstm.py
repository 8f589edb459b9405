"""xLSTM blocks (counterpart of ``repro/models/xlstm.py``,
[arXiv:2405.04517]): mLSTM (matrix memory, chunkwise-parallel like
linear attention with exponential gating; a Python loop over chunks
where the reference scans them) and sLSTM (scalar memory, a true
recurrence with state mixing; a Python loop over time).

mLSTM state: (C (B, H, Dk, Dv), n (B, H, Dk)); sLSTM state: (c, n, h,
m), each (B, H, Dh); all f32.  The tree keeps the reference's keys, the
(mLSTM, sLSTM) pairs stacked along a leading axis: ``mlstm``, ``slstm``,
``embed``, ``final_norm``, ``lm_head``; so does the cache (``mlstm_C``,
``mlstm_n``, ``mlstm_conv``, ``slstm_c``/``n``/``h``/``m``), which holds
recurrent state only, O(1) in the sequence length.

Prompts are left-padded, as in the reference, and ``forward(valid=)``
and ``prefill`` mask the pads so that the states after a left-padded
prefill equal an unpadded prefill's for any biases, where the
reference's do only while the biases are zero:
* mLSTM: the block input ``xi`` (before the conv) is zeroed at pads, and
  in ``mlstm_chunked(valid=)`` a pad position has forget gate 1 and a
  zero key, so it leaves (C, n) as they were (the reference's block has
  no pad mask: ``layernorm(0)`` is its bias vector, which flows into
  ``xi``, the gates and the state);
* sLSTM: ``slstm_scan(valid=)`` carries the old (c, n, h, m) through a
  pad (the reference adds -1e9 to the input gate, which rounds away
  against m's initial -1e9, so n, c and h accumulate at the pads);
* every block's update of the residual stream is zeroed at pads, so the
  hidden state there stays zero.
At zero biases this equals the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as TF

Params = Dict[str, torch.Tensor]

GATE_CLIP = 8.0   # clip of the exp input gate's pre-activation (f32 range)


def _keep(valid, like):
    """``valid`` (B, T) as a (B, T, 1...) mask broadcasting over ``like``."""
    return valid.reshape(*valid.shape, *[1] * (like.dim() - 2))


# ---------------------------------------------------------------------------
# mLSTM core
# ---------------------------------------------------------------------------


def mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int, init_state=None,
                  valid: Optional[torch.Tensor] = None):
    """q, k, v (B, T, H, D); i_pre, f_pre (B, T, H) gate pre-activations.
    Returns (h (B, T, H, D) in q's dtype, (C, n) final state).  ``valid``
    (B, T): a position outside it has forget gate 1 and adds nothing."""
    B, T, H, D = q.shape
    assert T % chunk == 0
    nc = T // chunk
    qf = q.float() / math.sqrt(D)
    kf, vf = k.float(), v.float()
    log_f = F.logsigmoid(f_pre.float())                     # <= 0
    log_i = torch.clamp(i_pre.float(), -GATE_CLIP, GATE_CLIP)
    if valid is not None:
        kf = kf * _keep(valid, kf)
        log_f = log_f * _keep(valid, log_f)

    def chunks(a):
        return a.reshape(B, nc, chunk, *a.shape[2:])
    qc, kc, vc, lfc, lic = (chunks(a) for a in (qf, kf, vf, log_f, log_i))
    if init_state is None:
        C = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    else:
        C, n = (s.float() for s in init_state)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    hs = []
    for c in range(nc):
        qk_, kk_, vk_, lf, li = (a[:, c] for a in (qc, kc, vc, lfc, lic))
        cs = torch.cumsum(lf, dim=1)                        # (B, c, H)
        total = cs[:, -1]                                   # (B, H)
        # intra-chunk: w[t, s] = exp(cs_t - cs_s + li_s), s <= t
        wlog = cs[:, :, None] - cs[:, None, :] + li[:, None, :]
        w = torch.where(mask, torch.exp(wlog), 0.0)          # (B, t, s, H)
        scores = torch.einsum("bthd,bshd->btsh", qk_, kk_) * w
        y_intra = torch.einsum("btsh,bshd->bthd", scores, vk_)
        den_intra = scores.sum(dim=2)                       # (B, c, H)
        # inter-chunk
        dec = torch.exp(cs)
        y_off = torch.einsum("bthd,bhde->bthe", qk_, C) * dec[..., None]
        den_off = torch.einsum("bthd,bhd->bth", qk_, n) * dec
        den = torch.clamp((den_intra + den_off).abs(), min=1.0)
        hs.append((y_intra + y_off) / den[..., None])
        # state update
        din = torch.exp(total[:, None] + li - cs)           # (B, c, H)
        kd = kk_ * din[..., None]
        C = C * torch.exp(total)[..., None, None] + torch.einsum(
            "bshd,bshe->bhde", kd, vk_)
        n = n * torch.exp(total)[..., None] + kd.sum(dim=1)
    h = torch.stack(hs, dim=1).reshape(B, T, H, D)
    return h.to(q.dtype), (C, n)


def mlstm_ref(q, k, v, i_pre, f_pre, init_state=None):
    """Sequential oracle."""
    B, T, H, D = q.shape
    qf = q.float() / math.sqrt(D)
    log_f = F.logsigmoid(f_pre.float())
    log_i = torch.clamp(i_pre.float(), -GATE_CLIP, GATE_CLIP)
    if init_state is None:
        C = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    else:
        C, n = (s.float() for s in init_state)
    hs = []
    for t in range(T):
        f = torch.exp(log_f[:, t])[..., None]
        i = torch.exp(log_i[:, t])[..., None]
        C = C * f[..., None] + i[..., None] * torch.einsum(
            "bhd,bhe->bhde", k[:, t].float(), v[:, t].float())
        n = n * f + i * k[:, t].float()
        num = torch.einsum("bhd,bhde->bhe", qf[:, t], C)
        den = torch.clamp(torch.einsum("bhd,bhd->bh", qf[:, t], n).abs(),
                          min=1.0)
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1).to(q.dtype), (C, n)


def mlstm_decode(q1, k1, v1, i1, f1, state):
    """One token: q1, k1, v1 (B, H, D); i1, f1 (B, H)."""
    C, n = state
    D = q1.shape[-1]
    f = torch.exp(F.logsigmoid(f1.float()))[..., None]
    i = torch.exp(torch.clamp(i1.float(), -GATE_CLIP, GATE_CLIP))[..., None]
    C = C * f[..., None] + i[..., None] * torch.einsum(
        "bhd,bhe->bhde", k1.float(), v1.float())
    n = n * f + i * k1.float()
    qf = q1.float() / math.sqrt(D)
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", qf, n).abs(), min=1.0)
    return (num / den[..., None]).to(q1.dtype), (C, n)


# ---------------------------------------------------------------------------
# sLSTM core (inherently sequential)
# ---------------------------------------------------------------------------


def slstm_scan(x_gates, R, state, valid: Optional[torch.Tensor] = None):
    """x_gates (B, T, 4, H, Dh): the input's contributions to (i, f, z, o);
    R (4, H, Dh, Dh) recurrent mixing; state (c, n, h, m) each (B, H, Dh).
    Returns (h_seq (B, T, H, Dh) f32, new state).  ``valid`` (B, T): the
    state is carried unchanged through a position outside it."""
    Rf = R.float()
    c, n, h, m = state
    hs = []
    for t in range(x_gates.shape[1]):
        rec = torch.einsum("bhd,ghde->bghe", h, Rf)          # (B, 4, H, Dh)
        g = x_gates[:, t].float() + rec
        it, ft, zt, ot = g.unbind(1)
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(torch.clamp(it - m_new, max=0.0))
        f_p = torch.exp(torch.clamp(ft + m - m_new, max=0.0))
        c_new = f_p * c + i_p * torch.tanh(zt)
        n_new = f_p * n + i_p
        h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
        if valid is None:
            c, n, h, m = c_new, n_new, h_new, m_new
        else:
            keep = valid[:, t, None, None]
            c, n, h, m = (torch.where(keep, new, old) for new, old in
                          ((c_new, c), (n_new, n), (h_new, h), (m_new, m)))
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


def slstm_init_state(B, H, Dh, device):
    z = torch.zeros((B, H, Dh), dtype=torch.float32, device=device)
    return (z, z, z, torch.full((B, H, Dh), -1e9, dtype=torch.float32,
                                device=device))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _norm_params(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def init_mlstm_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                     device) -> Params:
    d, H = cfg.d_model, cfg.num_heads
    d_inner = 2 * d
    Dh = d_inner // H

    def normal(*shape, sd):
        return (torch.randn(shape, generator=gen, device=device) * sd).to(
            dtype)
    sd, sdi = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_inner)
    b_if = torch.zeros((2, H), dtype=torch.float32, device=device)
    b_if[1] = 3.0
    return {
        "ln": _norm_params(d, dtype, device),
        "up": normal(d, 2 * d_inner, sd=sd),
        "conv_w": normal(4, d_inner, sd=0.5),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "wq": normal(d_inner, H, Dh, sd=sdi),
        "wk": normal(d_inner, H, Dh, sd=sdi),
        "wv": normal(d_inner, H, Dh, sd=sdi),
        "w_if": normal(d_inner, 2, H, sd=sdi),
        "b_if": b_if,
        "out_norm": torch.ones((H, Dh), dtype=dtype, device=device),
        "down": normal(d_inner, d,
                       sd=1.0 / math.sqrt(d_inner * 2 * cfg.num_layers)),
    }


def _masked(y, valid):
    return y if valid is None else torch.where(_keep(valid, y), y, 0)


def mlstm_block(p: Params, cfg: ModelConfig, x, state=None, conv_state=None,
                return_state: bool = False, valid=None):
    """x (B, T, d); state (C, n); conv_state (B, 3, d_inner).  Returns x
    plus the block's update [, ((C, n), conv state)]; ``valid`` (B, T)
    masks left pads (module docstring)."""
    B, T, d = x.shape
    d_inner = 2 * d
    h = L.layernorm(x, p["ln"]["scale"], p["ln"]["bias"])
    xi, z = (h @ p["up"]).chunk(2, dim=-1)
    xi = _masked(xi, valid)
    xc = S._causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)
    q = torch.einsum("bte,ehd->bthd", xc, p["wq"])
    k = torch.einsum("bte,ehd->bthd", xc, p["wk"])
    v = torch.einsum("bte,ehd->bthd", xi, p["wv"])
    gif = torch.einsum("bte,egh->btgh", xc, p["w_if"]).float() + p["b_if"]
    chunk = min(128, T)
    if T % chunk:
        chunk = T
    hseq, new_state = mlstm_chunked(q, k, v, gif[:, :, 0], gif[:, :, 1],
                                    chunk, state, valid=valid)
    hseq = L.rmsnorm(hseq, p["out_norm"])                # per-head norm
    out = (hseq.reshape(B, T, d_inner) * F.silu(z)) @ p["down"]
    x = x + _masked(out, valid)
    if return_state:
        return x, (new_state, S.conv_tail(xi, conv_state,
                                          p["conv_w"].shape[0]))
    return x


def mlstm_block_decode(p: Params, cfg: ModelConfig, x1, state, conv_state):
    """x1 (B, d) -> (x1 plus the update, (C, n), conv window)."""
    B, d = x1.shape
    h = L.layernorm(x1, p["ln"]["scale"], p["ln"]["bias"])
    xi, z = (h @ p["up"]).chunk(2, dim=-1)
    xc, win = S.conv_step(conv_state, xi, p["conv_w"], p["conv_b"])
    q = torch.einsum("be,ehd->bhd", xc, p["wq"])
    k = torch.einsum("be,ehd->bhd", xc, p["wk"])
    v = torch.einsum("be,ehd->bhd", xi, p["wv"])
    gif = torch.einsum("be,egh->bgh", xc, p["w_if"]).float() + p["b_if"]
    h1, new_state = mlstm_decode(q, k, v, gif[:, 0], gif[:, 1], state)
    h1 = L.rmsnorm(h1, p["out_norm"])
    out = (h1.reshape(B, 2 * d) * F.silu(z)) @ p["down"]
    return x1 + out, new_state, win


def init_slstm_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                     device) -> Params:
    d, H = cfg.d_model, cfg.num_heads
    Dh = d // H

    def normal(*shape, sd, dt=dtype):
        return (torch.randn(shape, generator=gen, device=device) * sd).to(dt)
    b_gates = torch.zeros((4, H, Dh), dtype=torch.float32, device=device)
    b_gates[1] = 3.0                                     # forget-gate bias
    return {
        "ln": _norm_params(d, dtype, device),
        "w_gates": normal(d, 4, H, Dh, sd=1.0 / math.sqrt(d)),
        "b_gates": b_gates,
        "R": normal(4, H, Dh, Dh, sd=1.0 / math.sqrt(Dh), dt=torch.float32),
        "out_norm": torch.ones((H, Dh), dtype=dtype, device=device),
        "proj": normal(d, d, sd=1.0 / math.sqrt(d)),
        "ffn": L.init_mlp(gen, d, int(math.ceil(4 / 3 * d)), True,
                          cfg.num_layers, dtype, device),
        "ln2": _norm_params(d, dtype, device),
    }


def slstm_block(p: Params, cfg: ModelConfig, x, state=None,
                return_state: bool = False, valid=None):
    """x (B, T, d); state (c, n, h, m) or None (the initial state)."""
    B, T, d = x.shape
    H = cfg.num_heads
    h = L.layernorm(x, p["ln"]["scale"], p["ln"]["bias"])
    xg = torch.einsum("btd,dghe->btghe", h, p["w_gates"]).float() \
        + p["b_gates"]
    if state is None:
        state = slstm_init_state(B, H, d // H, x.device)
    hseq, new_state = slstm_scan(xg, p["R"], state, valid=valid)
    hseq = L.rmsnorm(hseq.to(x.dtype), p["out_norm"])
    x = x + _masked(hseq.reshape(B, T, d) @ p["proj"], valid)
    h2 = L.layernorm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    x = x + _masked(L.mlp(p["ffn"], h2, "gelu", True), valid)
    if return_state:
        return x, new_state
    return x


def slstm_block_decode(p: Params, cfg: ModelConfig, x1, state):
    x, new_state = slstm_block(p, cfg, x1[:, None], state, return_state=True)
    return x[:, 0], new_state


# ---------------------------------------------------------------------------
# The model: (mLSTM, sLSTM) pairs
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights with the reference's scales and tree."""
    dtype, d = cfg.param_dtype, cfg.d_model
    n_pairs = cfg.num_layers // 2
    m_blocks, s_blocks = [], []
    for _ in range(n_pairs):
        m_blocks.append(init_mlstm_block(generator, cfg, dtype, device))
        s_blocks.append(init_slstm_block(generator, cfg, dtype, device))

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)
    return {
        "embed": (normal(cfg.vocab_size, d) / math.sqrt(d)).to(dtype),
        "mlstm": TF.stack(m_blocks),
        "slstm": TF.stack(s_blocks),
        "final_norm": _norm_params(d, dtype, device),
        "lm_head": (normal(d, cfg.vocab_size) / math.sqrt(d)).to(dtype),
    }


def _pairs(params: Params, cfg: ModelConfig):
    for i in range(cfg.num_layers // 2):
        yield i, TF.pick(params["mlstm"], i), TF.pick(params["slstm"], i)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (B, S, V).  ``valid`` (B, S) bool masks left pads: their
    embeddings are zeroed and no block reads or updates anything there
    (module docstring).  With ``cfg.remat`` each mLSTM + sLSTM pair is
    recomputed in the backward."""
    x = TF.embed_tokens(params, cfg, tokens)
    if valid is not None:
        x = _masked(x, valid)

    def pair(x, i):
        x = mlstm_block(TF.pick(params["mlstm"], i), cfg, x, valid=valid)
        return slstm_block(TF.pick(params["slstm"], i), cfg, x, valid=valid)

    body = L.remat(cfg, pair)
    for i in range(cfg.num_layers // 2):
        x = body(x, i)
    return TF.lm_logits(params, cfg, x)


STATE_KEYS = ("mlstm_C", "mlstm_n", "mlstm_conv", "slstm_c", "slstm_n",
              "slstm_h", "slstm_m")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype: Optional[torch.dtype] = None):
    """Recurrent state only, O(1) in the sequence length (``max_len`` is
    not used)."""
    dtype = dtype or cfg.compute_dtype
    d, H = cfg.d_model, cfg.num_heads
    n_pairs = cfg.num_layers // 2
    Dm, Ds = 2 * d // H, d // H

    def zeros(*shape, dt=torch.float32):
        return torch.zeros((n_pairs, batch) + shape, dtype=dt, device=device)
    return {"mlstm_C": zeros(H, Dm, Dm), "mlstm_n": zeros(H, Dm),
            "mlstm_conv": zeros(3, 2 * d, dt=dtype),
            "slstm_c": zeros(H, Ds), "slstm_n": zeros(H, Ds),
            "slstm_h": zeros(H, Ds), "slstm_m": zeros(H, Ds).fill_(-1e9)}


def _store(cache, i, C, n, conv, s_state):
    for name, val in zip(STATE_KEYS, (C, n, conv) + tuple(s_state)):
        cache[name][i] = val.to(cache[name].dtype)


def prefill(params: Params, cfg: ModelConfig, tokens, cache, prompt_lens,
            return_logits: bool = True):
    """tokens (B, S) left-padded (row b's ``prompt_lens[b]`` tokens end at
    column S - 1).  The mLSTM starts from zero state, the sLSTM from the
    cache's, as in the reference; every state is written into ``cache``
    in place.  Returns (logits (B, S, V) or None, cache)."""
    B, T = tokens.shape
    lens = prompt_lens.to(tokens.device).long()
    valid = (torch.arange(T, device=tokens.device)[None]
             - (T - lens)[:, None]) >= 0
    x = _masked(TF.embed_tokens(params, cfg, tokens), valid)
    for i, mp, sp in _pairs(params, cfg):
        x, ((C, n), conv) = mlstm_block(mp, cfg, x, return_state=True,
                                        valid=valid)
        s0 = tuple(cache[k][i] for k in STATE_KEYS[3:])
        x, s_state = slstm_block(sp, cfg, x, s0, return_state=True,
                                 valid=valid)
        _store(cache, i, C, n, conv, s_state)
    logits = TF.lm_logits(params, cfg, x) if return_logits else None
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, token, cache,
                kv_len=None):
    """token (B,) -> (logits (B, V), cache), every state updated in place
    (``kv_len`` is not used: the state holds the history)."""
    del kv_len
    x = TF.embed_tokens(params, cfg, token[:, None])[:, 0]
    for i, mp, sp in _pairs(params, cfg):
        x, (C, n), conv = mlstm_block_decode(
            mp, cfg, x, (cache["mlstm_C"][i], cache["mlstm_n"][i]),
            cache["mlstm_conv"][i])
        x, s_state = slstm_block_decode(
            sp, cfg, x, tuple(cache[k][i] for k in STATE_KEYS[3:]))
        _store(cache, i, C, n, conv, s_state)
    return TF.lm_logits(params, cfg, x), cache
