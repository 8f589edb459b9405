"""Mamba2 (SSD) blocks (counterpart of ``repro/models/ssm.py``): the
chunked state-space dual form for training and prefill (a Python loop
over chunks where the reference scans them: the quadratic intra-chunk
term, states only at chunk boundaries) and the O(1) recurrent decode.

Shapes follow the Mamba2 minimal formulation, as in the reference:
  x       : (B, T, H, P)    SSM-head inputs (P = head channels)
  dt      : (B, T, H)       discretisation step (softplus + bias)
  A       : (H,)            negative decay rate;  a_log = dt * A
  B_, C_  : (B, T, G, N)    input/output projections (G groups, GQA-style)
  state   : (B, H, N, P)    f32

The SSM state is f32, as are ``A_log``, ``dt_bias`` and ``D``.  On one
device the reference's ``logical_constraint`` is the identity, so it has
no counterpart here.

Two departures from the reference:
* for left-padded prefill, ``mamba2_forward(valid=)`` zeroes the SSD
  input ``x_in`` at pad positions.  The reference feeds the pads'
  ``silu(conv bias) * dt`` into the state, so its left-padded prefill
  leaves a state other than the unpadded prompt's once the conv biases
  are not zero; with the mask the state equals the unpadded one (the
  leading pads see a zero state, so their decay changes nothing).  At
  zero conv biases the two agree;
* the full-sequence causal conv (``_causal_conv``: forward and prefill)
  computes in f32 and rounds its output once, as the decode step's conv
  does in both packages; the reference's forward rounds every product
  and partial sum to the working dtype.  In f32 the two are the same;
  in bf16 the port's engine (prefill, then decode) and its trainer
  (forward) then compute one conv, where the reference's differ, so the
  engine's logprobs sit closer to the trainer's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Core SSD scan
# ---------------------------------------------------------------------------


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., T) -> (..., T, T) with out[t, s] = sum_{s < r <= t} a_r
    (lower-triangular cumulative segment sums; -inf above the diagonal)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, a_log: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, P) in x's dtype, final state (B, H, N, P) f32).

    A loop over T / chunk chunks: each adds its quadratic intra-chunk
    term and the incoming state's, then carries the state on.  A T that
    is not a multiple of ``chunk`` is padded at the tail with x = 0 and
    a_log = 0 (decay 1), so the state passes through."""
    Bsz, T, H, Pdim = x.shape
    G, N = B_.shape[2], B_.shape[3]
    T_orig = T
    if T % chunk:
        pad = chunk - T % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
        T = T + pad
    nc = T // chunk
    rep = H // G
    xc = x.float().reshape(Bsz, nc, chunk, H, Pdim)
    ac = a_log.float().reshape(Bsz, nc, chunk, H)
    Bc = B_.float().reshape(Bsz, nc, chunk, G, N)
    Cc = C_.float().reshape(Bsz, nc, chunk, G, N)
    state = (torch.zeros((Bsz, H, N, Pdim), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        xk, ak, Bk, Ck = xc[:, c], ac[:, c], Bc[:, c], Cc[:, c]
        cs = torch.cumsum(ak, dim=1)                         # (B, c, H)
        total = cs[:, -1]                                    # (B, H)
        # intra-chunk: Lmat[t, s] = exp(sum_{s<r<=t} a_r), causal; the
        # G groups' C B^T broadcast over their heads
        Lmat = torch.exp(_segsum(ak.transpose(1, 2)))       # (B, H, c, c)
        CB = torch.einsum("btgn,bsgn->bgts", Ck, Bk)         # (B, G, c, c)
        M = (Lmat.view(Bsz, G, rep, chunk, chunk) * CB[:, :, None]
             ).view(Bsz, H, chunk, chunk)
        y_diag = torch.einsum("bhts,bshp->bthp", M, xk)
        # inter-chunk: the incoming state's contribution
        Ch = Ck.repeat_interleave(rep, dim=2)                # (B, c, H, N)
        y_off = torch.einsum("bthn,bhnp->bthp", Ch, state) \
            * torch.exp(cs)[..., None]
        # state update: S' = S exp(total) + sum_s B_s x_s exp(total - cs_s)
        Bh = Bk.repeat_interleave(rep, dim=2)                # (B, c, H, N)
        decay_in = torch.exp(total[:, None] - cs)            # (B, c, H)
        s_add = torch.einsum("bshn,bshp->bhnp", Bh * decay_in[..., None], xk)
        state = state * torch.exp(total)[..., None, None] + s_add
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(Bsz, T, H, Pdim)[:, :T_orig]
    return y.to(x.dtype), state


def ssd_ref(x, a_log, B_, C_, init_state=None):
    """Sequential oracle: the plain recurrence h_t = exp(a_t) h_{t-1} +
    B_t x_t, y_t = C_t h_t."""
    Bsz, T, H, Pdim = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    h = (torch.zeros((Bsz, H, N, Pdim), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(T):
        a = torch.exp(a_log[:, t].float())                       # (B, H)
        Bt = B_[:, t].float().repeat_interleave(rep, dim=1)      # (B, H, N)
        Ct = C_[:, t].float().repeat_interleave(rep, dim=1)
        h = h * a[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bt, x[:, t].float())
        ys.append(torch.einsum("bhn,bhnp->bhp", Ct, h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_decode(x1, a_log1, B1, C1, state):
    """One step.  x1 (B, H, P); a_log1 (B, H); B1/C1 (B, G, N); state
    (B, H, N, P) f32 -> (y (B, H, P), new state)."""
    rep = x1.shape[1] // B1.shape[1]
    a = torch.exp(a_log1.float())
    Bh = B1.float().repeat_interleave(rep, dim=1)
    Ch = C1.float().repeat_interleave(rep, dim=1)
    state = state * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh, x1.float())
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    return y.to(x1.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> conv -> SSD -> gate -> norm -> out_proj)
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = s.num_heads or d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.state_dim
    return d_inner, nheads, conv_dim


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> Params:
    """The reference's tree and scales: the projections kept per segment
    (z / x / BC / dt), f32 ``A_log``, ``dt_bias`` and ``D``."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, _ = mamba2_dims(cfg)
    gN = 2 * s.ngroups * s.state_dim

    def normal(*shape, sd):
        return (torch.randn(shape, generator=gen, device=device) * sd).to(
            dtype)
    f32 = torch.float32
    sd = 1.0 / math.sqrt(d)
    sk = 1.0 / math.sqrt(s.conv_width)
    return {
        "in_z": normal(d, d_inner, sd=sd),
        "in_x": normal(d, d_inner, sd=sd),
        "in_bc": normal(d, gN, sd=sd),
        "in_dt": normal(d, nheads, sd=sd),
        "conv_x_w": normal(s.conv_width, d_inner, sd=sk),
        "conv_x_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "conv_bc_w": normal(s.conv_width, gN, sd=sk),
        "conv_bc_b": torch.zeros((gN,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, dtype=f32,
                                          device=device)),
        "dt_bias": torch.zeros((nheads,), dtype=f32, device=device),
        "D": torch.ones((nheads,), dtype=f32, device=device),
        "gate_norm": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": normal(d_inner, d,
                           sd=1.0 / math.sqrt(d_inner * 2 * cfg.num_layers)),
    }


def _causal_conv(xconv: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, then silu, in xconv's dtype.  xconv (B, T,
    Cd); w (K, Cd); ``init`` (B, K-1, Cd) the window before the first
    column (zeros when None).  Products, sum and silu in f32, rounded
    once, as the decode step's ``conv_step`` computes them (module
    docstring)."""
    K = w.shape[0]
    if init is None:
        pad = xconv.new_zeros((xconv.shape[0], K - 1, xconv.shape[2]))
    else:
        pad = init.to(xconv.dtype)
    xp = torch.cat([pad, xconv], dim=1).float()
    T = xconv.shape[1]
    out = sum(xp[:, i:i + T] * w[i].float() for i in range(K))
    return F.silu(out + b.float()).to(xconv.dtype)


def conv_tail(seq: torch.Tensor, prev: Optional[torch.Tensor], K: int
              ) -> torch.Tensor:
    """The last K-1 conv inputs after ``seq`` (B, T, Cd): the conv state
    a decode continues from (``prev`` or zeros before a short T)."""
    B, T, dim = seq.shape
    if T >= K - 1:
        return seq[:, T - (K - 1):]
    if prev is None:
        prev = seq.new_zeros((B, K - 1 - T, dim))
    return torch.cat([prev.to(seq.dtype), seq], dim=1)[:, -(K - 1):]


def mamba2_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                   init_state=None, conv_init=None,
                   return_state: bool = False,
                   valid: Optional[torch.Tensor] = None):
    """x (B, T, d) -> (B, T, d) [, (ssm_state, (conv_x, conv_bc))].
    ``valid`` (B, T) bool: positions outside it (left pads) put nothing
    into the SSM state (module docstring)."""
    s = cfg.ssm
    d_inner, nheads, _ = mamba2_dims(cfg)
    Bsz, T, _ = x.shape
    z = x @ p["in_z"]
    xi = x @ p["in_x"]
    bc = x @ p["in_bc"]
    dt = x @ p["in_dt"]
    ci_x, ci_bc = conv_init if conv_init is not None else (None, None)
    xs = _causal_conv(xi, p["conv_x_w"], p["conv_x_b"], ci_x)
    bc_out = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"], ci_bc)
    B_, C_ = bc_out.chunk(2, dim=-1)
    xs = xs.reshape(Bsz, T, nheads, s.head_dim)
    B_ = B_.reshape(Bsz, T, s.ngroups, s.state_dim)
    C_ = C_.reshape(Bsz, T, s.ngroups, s.state_dim)
    dt_s = F.softplus(dt.float() + p["dt_bias"])                 # (B, T, H)
    a_log = dt_s * -torch.exp(p["A_log"])
    x_in = xs.float() * dt_s[..., None]
    if valid is not None:
        x_in = x_in * valid[:, :, None, None]
    y, final = ssd_chunked(x_in.to(x.dtype), a_log, B_, C_,
                           min(s.chunk_size, T), init_state)
    y = y.float() + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, T, d_inner) * F.silu(z.float())
    y = L.rmsnorm(y.to(x.dtype), p["gate_norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        K = p["conv_x_w"].shape[0]
        return out, (final, (conv_tail(xi, ci_x, K), conv_tail(bc, ci_bc, K)))
    return out


def conv_step(win_prev: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor):
    """One decode step of the causal conv: the window (B, K-1, Cd) and
    the new input (B, Cd) -> (silu(conv + b) in new's dtype, the window
    shifted by one).  f32 products and sum, as the reference's."""
    win = torch.cat([win_prev.to(new.dtype), new[:, None]], dim=1)
    out = F.silu(torch.einsum("bkc,kc->bc", win.float(), w.float())
                 + b.float()).to(new.dtype)
    return out, win[:, 1:]


def mamba2_decode(p: Params, cfg: ModelConfig, x1: torch.Tensor,
                  ssm_state: torch.Tensor, conv_state):
    """x1 (B, d) one token; conv_state (conv_x (B, K-1, d_inner),
    conv_bc (B, K-1, 2 G N)) -> (out (B, d), ssm_state, conv_state)."""
    s = cfg.ssm
    d_inner, nheads, _ = mamba2_dims(cfg)
    Bsz = x1.shape[0]
    z = x1 @ p["in_z"]
    xi = x1 @ p["in_x"]
    bc = x1 @ p["in_bc"]
    dt = x1 @ p["in_dt"]
    cx, cbc = conv_state
    xs, cx = conv_step(cx, xi, p["conv_x_w"], p["conv_x_b"])
    bc_out, cbc = conv_step(cbc, bc, p["conv_bc_w"], p["conv_bc_b"])
    B_, C_ = bc_out.chunk(2, dim=-1)
    xs = xs.reshape(Bsz, nheads, s.head_dim)
    B_ = B_.reshape(Bsz, s.ngroups, s.state_dim)
    C_ = C_.reshape(Bsz, s.ngroups, s.state_dim)
    dt_s = F.softplus(dt.float() + p["dt_bias"])
    a_log1 = dt_s * -torch.exp(p["A_log"])
    x_in = xs.float() * dt_s[..., None]
    y, ssm_state = ssd_decode(x_in.to(x1.dtype), a_log1, B_, C_, ssm_state)
    y = y.float() + xs.float() * p["D"][None, :, None]
    y = y.reshape(Bsz, d_inner) * F.silu(z.float())
    y = L.rmsnorm(y.to(x1.dtype), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], ssm_state, (cx, cbc)
