"""Mamba2 (SSD) block: the chunked state-space-duality algorithm.

Counterpart of the JAX package's ``models/ssm.py``, step for step.  State
per head: h in R^{head_dim x state_dim}, with the recurrence

    h_t = exp(dt_t·A) · h_{t-1} + dt_t · x_t ⊗ B_t,      y_t = h_t · C_t + D·x_t

scalar A per head and B/C shared across heads (one group).  A sequence runs
the chunked form: an attention-like product inside each chunk plus a short
scan over the chunk states; a cached step runs the recurrence.  JAX writes
all of it in jnp, outside any Pallas kernel, so here it is plain PyTorch
(``einsum``/``matmul`` for the products); its two ``lax.scan``s (over
chunks, and over layers in the model) are Python loops.

Where the port differs from JAX: :func:`mamba2_block` with a cache writes
the new SSD state and conv state into the cache **in place** (a captured
CUDA graph replays against fixed addresses), and it refuses ``S > 1`` with
a cache, where JAX's recurrent branch silently reads token 0 only.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import keep_shards, on_local_shards, replicate_like

from .layers import HEADS, ROWS, Shape

Params = Mapping[str, torch.Tensor]
# the float32 leaves of a Mamba2 layer; the rest is the model's dtype
F32_LEAVES = ("conv_b", "A_log", "D", "dt_bias")
# the named dimensions of the conv's input and state (B, ·, C), and of the
# SSD state (B, H, hd, ds), for the block's cores run on each device's shards
CHANNELS = {"batch": 0, "channels": 2}
STATE = {"batch": 0, "heads": 1}


def ssm_dims(cfg) -> tuple[int, int, int]:
    """(d_inner, heads, conv channels) of the config's Mamba2 block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.state_dim
    return d_inner, n_heads, conv_ch


def mamba2_shapes(cfg) -> dict[str, Shape]:
    """Leaf name → shape and logical axes of one layer's Mamba2 parameters,
    as ``init_mamba2`` makes them in JAX (``w_in`` is ordered ``[z | xBC |
    dt]``)."""
    s, d = cfg.ssm, cfg.d_model
    d_inner, H, conv_ch = ssm_dims(cfg)
    return {
        "w_in": Shape((d, 2 * d_inner + 2 * s.state_dim + H), "fsdp mlp"),
        "conv_w": Shape((s.conv_width, conv_ch), "_ mlp"),
        "conv_b": Shape((conv_ch,), "_"),
        "A_log": Shape((H,), "_"),
        "D": Shape((H,), "_"),
        "dt_bias": Shape((H,), "_"),
        "w_out": Shape((d_inner, d), "mlp fsdp"),
    }


def _split_in(z_xbc_dt: torch.Tensor, cfg):
    d_inner, _, conv_ch = ssm_dims(cfg)
    z = z_xbc_dt[..., :d_inner]
    xbc = z_xbc_dt[..., d_inner:d_inner + conv_ch]
    dt_raw = z_xbc_dt[..., d_inner + conv_ch:]
    return z, xbc, dt_raw


def _causal_conv(xbc: torch.Tensor, p: Params, conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width ``conv_width`` over xbc (B, S, C),
    after the ``W - 1`` inputs of ``conv_state`` (zeros without one).
    Returns ``(silu(conv + bias), the last W - 1 inputs)``.  A DTensor
    runs on each device's rows, and channels where its layout shards them
    (the conv is depthwise)."""
    if isinstance(xbc, DTensor):
        xbc = keep_shards(xbc, (0, 2))
        return on_local_shards(_conv_local, xbc, CHANNELS, [
            (xbc, CHANNELS), (p["conv_w"], {"channels": 1}), (p["conv_b"], {"channels": 0}),
            (conv_state, CHANNELS)], [CHANNELS, CHANNELS])
    w = p["conv_w"].to(xbc.dtype)                             # (W, C)
    W = w.shape[0]
    if conv_state is not None:
        ctx = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    else:
        ctx = F.pad(xbc, (0, 0, W - 1, 0))
    new_state = ctx[:, -(W - 1):]
    S = xbc.shape[1]
    out = ctx[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + ctx[:, i:i + S] * w[i]
    out = out + p["conv_b"].to(xbc.dtype)
    return F.silu(out), new_state


def _conv_local(xbc, conv_w, conv_b, conv_state):
    """:func:`_causal_conv` of one device's shards."""
    return _causal_conv(xbc, {"conv_w": conv_w, "conv_b": conv_b}, conv_state)


def _ssd_chunked(x, dtv, ldec, Bm, Cm, h0, chunk: int):
    """Chunked SSD scan.

    x (B,S,H,hd) per-head inputs; dtv (B,S,H) softplus(dt); ldec (B,S,H)
    log decay dt·A (negative); Bm/Cm (B,S,ds) shared maps; h0 (B,H,hd,ds)
    incoming state.  Returns y (B,S,H,hd) and the outgoing state."""
    Bsz, S, H, hd = x.shape
    ds = Bm.shape[-1]
    nc = S // chunk
    assert nc * chunk == S, (S, chunk)
    xc = x.reshape(Bsz, nc, chunk, H, hd)
    dtc = dtv.reshape(Bsz, nc, chunk, H)
    lc = ldec.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, ds)
    Cc = Cm.reshape(Bsz, nc, chunk, ds)

    lcum = torch.cumsum(lc, dim=2)                            # (B,nc,L,H)
    ltot = lcum[:, :, -1]                                     # (B,nc,H)

    # intra-chunk (attention-like, lower-triangular)
    cb = torch.einsum("bntk,bnsk->bnts", Cc, Bc)              # (B,nc,L,L)
    decay = torch.exp(torch.clamp(lcum[:, :, :, None] - lcum[:, :, None, :], -60.0, 0.0))
    mask = replicate_like(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril(),
                          cb)
    m = cb[..., None] * decay * dtc[:, :, None]               # (B,nc,t,s,H)
    m = torch.where(mask[None, None, :, :, None], m, 0.0)
    y_intra = torch.einsum("bntsh,bnshd->bnthd", m, xc)

    # chunk states
    sdecay = torch.exp(torch.clamp(ltot[:, :, None] - lcum, -60.0, 0.0))   # (B,nc,L,H)
    states = torch.einsum("bnsh,bnshd,bnsk->bnhdk", sdecay * dtc, xc, Bc)

    # inter-chunk scan (nc steps): the state entering each chunk
    h, h_prevs = h0, []
    for n in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(ltot[:, n])[:, :, None, None] + states[:, n]
    h_prev = torch.stack(h_prevs, dim=1)                      # (B,nc,H,hd,ds)

    y_inter = torch.einsum("bnth,bntk,bnhdk->bnthd",
                           torch.exp(torch.clamp(lcum, -60.0, 0.0)), Cc, h_prev)
    return (y_intra + y_inter).reshape(Bsz, S, H, hd), h


def _ssd_scan(x, dt_raw, Bm, Cm, dt_bias, A_log, h0, chunk: int):
    """The chunked SSD of a sequence from its raw ``dt`` (B,S,H): y
    (B,S,H,hd)."""
    dtv = F.softplus(dt_raw.float() + dt_bias)                # (B,S,H)
    ldec = dtv * -torch.exp(A_log)
    return _ssd_chunked(x, dtv, ldec, Bm, Cm, h0, chunk)[0]


def mamba2_block(p: Params, x: torch.Tensor, cfg, *, cache: Optional[dict] = None):
    """x (B, S, D) → ``(out, new_cache)``.

    Without a cache and S > 1: the chunked form, chunk ``min(ssm.chunk,
    S)`` halved until it divides S; ``new_cache`` is None.  With a cache
    ``{"h": (B,H,hd,ds) float32, "conv": (B,W-1,C)}`` (or S == 1 without
    one): one recurrent step; with a cache both leaves are updated in place
    and the cache is returned.  A cache with S > 1 raises ``ValueError``:
    the recurrent step takes one token (JAX reads token 0 and drops the
    rest)."""
    s = cfg.ssm
    d_inner, H, _ = ssm_dims(cfg)
    B_, S, _ = x.shape
    if cache is not None and S != 1:
        raise ValueError(
            f"mamba2_block with a cache steps one token at a time; got S = {S} "
            "(the JAX version reads token 0 only and drops the rest)")

    z, xbc, dt_raw = _split_in(x @ p["w_in"], cfg)
    xbc, conv_state = _causal_conv(xbc, p, cache["conv"] if cache is not None else None)

    x_ssm = xbc[..., :d_inner].reshape(B_, S, H, s.head_dim)
    Bm = xbc[..., d_inner:d_inner + s.state_dim].float()
    Cm = xbc[..., d_inner + s.state_dim:].float()

    new_cache = None
    if cache is None and S > 1:
        chunk = min(s.chunk, S)
        while S % chunk:
            chunk //= 2
        h0 = replicate_like(torch.zeros((B_, H, s.head_dim, s.state_dim), dtype=torch.float32,
                                        device=x.device), x)
        args = (x_ssm.float(), dt_raw, Bm, Cm, p["dt_bias"], p["A_log"], h0, chunk)
        if isinstance(x, DTensor):
            # each device scans its own rows, and heads where the layout
            # shards them: the scan is independent per row and head
            like = keep_shards(args[0], (0, 2))
            y = on_local_shards(_ssd_scan, like, HEADS, list(zip(
                (like,) + args[1:],
                (HEADS, HEADS, ROWS, ROWS, {"heads": 0}, {"heads": 0}, STATE, {}))), [HEADS])
        else:
            y = _ssd_scan(*args)
    else:
        dtv = F.softplus(dt_raw.float() + p["dt_bias"])       # (B,S,H)
        ldec = dtv * -torch.exp(p["A_log"])
        h0 = cache["h"] if cache is not None else replicate_like(torch.zeros(
            (B_, H, s.head_dim, s.state_dim), dtype=torch.float32, device=x.device), x)
        xs = x_ssm.float()[:, 0]                              # (B,H,hd)
        h_out = (h0 * torch.exp(ldec[:, 0])[:, :, None, None]
                 + torch.einsum("bh,bhd,bk->bhdk", dtv[:, 0], xs, Bm[:, 0]))
        y = torch.einsum("bhdk,bk->bhd", h_out, Cm[:, 0])[:, None]
        if cache is not None:
            cache["h"].copy_(h_out)
            cache["conv"].copy_(conv_state)
            new_cache = cache
        else:
            new_cache = {"h": h_out, "conv": conv_state}

    y = y + p["D"][None, None, :, None] * x_ssm.float()
    y = y.reshape(B_, S, d_inner).to(x.dtype)
    y = y * F.silu(z)
    return y @ p["w_out"], new_cache
