"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory with recurrent gate connections).

Counterpart of the JAX package's ``models/xlstm.py``, step for step: both
use exponential gating with the max-stabilizer state m; a sequence runs the
mLSTM in its chunked-parallel form, a cached step runs its recurrence, and
the sLSTM always steps.  JAX writes them in jnp, outside any Pallas kernel,
so here they are plain PyTorch; its ``lax.scan``s are Python loops.  With a
cache, both blocks write their new state into it **in place** (a captured
CUDA graph replays against fixed addresses) and return it.

State per head (cache layout):
  mLSTM: C (hd, hd) matrix memory, n (hd) normalizer, m () stabilizer
  sLSTM: c, n, m, h  each (d_model,)
"""

from __future__ import annotations

import functools
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed import keep_shards, on_local_shards, replicate_like

from .layers import HEADS, ROWS, Shape

Params = Mapping[str, torch.Tensor]
# the float32 leaves of the two cells; the rest is the model's dtype
F32_LEAVES = ("w_if", "b_if", "b_gates")
# the named dimensions of the mLSTM state C (B,H,hd,hd), n (B,H,hd), m (B,H)
STATE = {"batch": 0, "heads": 1}


def _heads(cfg) -> tuple[int, int]:
    return cfg.n_heads, cfg.d_model // cfg.n_heads


def mlstm_shapes(cfg) -> dict[str, Shape]:
    """Leaf name → shape and logical axes of an mLSTM cell, as
    ``init_mlstm`` makes them."""
    d = cfg.d_model
    H, _ = _heads(cfg)
    d_up = int(d * cfg.xlstm.proj_factor)
    return {"w_up": Shape((d, 2 * d_up), "fsdp mlp"), "w_qkv": Shape((d_up, 3 * d_up), "mlp _"),
            "w_if": Shape((d_up, 2 * H), "mlp _"), "b_if": Shape((2 * H,), "_"),
            "w_down": Shape((d_up, d), "mlp fsdp")}


def slstm_shapes(cfg) -> dict[str, Shape]:
    """Leaf name → shape and logical axes of an sLSTM cell, as
    ``init_slstm`` makes them."""
    d = cfg.d_model
    return {"w_gates": Shape((d, 4 * d), "fsdp mlp"), "r_gates": Shape((d, 4 * d), "fsdp mlp"),
            "b_gates": Shape((4 * d,), "_"), "w_out": Shape((d, d), "fsdp fsdp")}


def gate_bias(name: str, n: int) -> torch.Tensor:
    """The initial gate biases (float32): ``b_if`` is input gates 0 then
    forget gates 3 (``n`` = 2H); ``b_gates`` is i 0, f 3, z and o 0 (``n``
    = 4D)."""
    b = torch.zeros(n)
    if name == "b_if":
        b[n // 2:] = 3.0
    else:
        b[n // 4: n // 2] = 3.0
    return b


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class _RunningMax(torch.autograd.Function):
    """``torch.cummax(g, dim=1).values`` with a deterministic gradient.

    The gradient of each position t goes to the position its running max
    came from, ``idx[t]``.  cummax's own backward adds them with
    ``scatter_add``, whose atomics on CUDA sum a long run in another order
    each time, so two runs of a training step differ.  Here: ``idx`` is
    constant on runs that start where the running max is new (``idx[s] ==
    s``), so a start gets the sum of the gradient over its run, a
    difference of reverse cumulative sums in float64 (along dim 1, which
    CUDA scans one sequence to a thread, in one order)."""

    @staticmethod
    def forward(ctx, g):
        values, idx = torch.cummax(g, dim=1)
        ctx.save_for_backward(idx)
        return values

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        S = grad.shape[1]
        pos = torch.arange(S, device=grad.device).view(1, S, *([1] * (grad.dim() - 2)))
        start = idx == pos
        after = grad.double().flip(1).cumsum(1).flip(1)        # sum over u >= t
        after = torch.cat([after, torch.zeros_like(after[:, :1])], dim=1)
        # the start of the run after t's: the first start past t (S at the end)
        nxt = torch.where(start, pos, S).flip(1).cummin(1).values.flip(1)
        nxt = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], S)], dim=1)
        run = after[:, :S] - after.gather(1, nxt)
        return torch.where(start, run, 0.0).to(grad.dtype)


def _mlstm_chunked(q, k, v, log_i, log_f, C0, n0, m0, chunk: int):
    """Chunked parallel mLSTM: the gates depend only on the input, so the
    matrix-memory recurrence unrolls to a decay-weighted attention form
    computed per chunk, with a short cross-chunk scan carrying (C, n, m).

    q,k,v (B,S,H,hd); log_i/log_f (B,S,H); C0 (B,H,hd,hd); n0 (B,H,hd);
    m0 (B,H).  Returns h (B,S,H,hd) and (C, n, m) after the last token."""
    B, S, H, hd = q.shape
    nc = S // chunk
    assert nc * chunk == S, (S, chunk)
    qf, kf, vf = q.float(), k.float(), v.float()

    # global running log-decay and stabilizer (a running max: a prefix op)
    Fg = torch.cumsum(log_f, dim=1)                           # (B,S,H)
    g = log_i - Fg
    a = torch.maximum(_RunningMax.apply(g), m0[:, None])
    m = Fg + a                                                # (B,S,H)

    qc = qf.reshape(B, nc, chunk, H, hd)
    kc = kf.reshape(B, nc, chunk, H, hd)
    vc = vf.reshape(B, nc, chunk, H, hd)
    Fc = Fg.reshape(B, nc, chunk, H)
    mc = m.reshape(B, nc, chunk, H)
    lic = log_i.reshape(B, nc, chunk, H)

    # intra-chunk, all chunks at once
    qk = torch.einsum("bnthd,bnshd->bntsh", qc, kc)           # (B,nc,t,s,H)
    w_intra = torch.exp(torch.clamp(
        Fc[:, :, :, None] - Fc[:, :, None, :] + lic[:, :, None, :] - mc[:, :, :, None],
        -60.0, 30.0))
    mask = replicate_like(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril(),
                          qk)
    scores = torch.where(mask[None, None, :, :, None], qk * w_intra, 0.0)
    num_intra = torch.einsum("bntsh,bnshd->bnthd", scores, vc)
    den_intra = scores.sum(dim=3)                             # (B,nc,t,H)

    # chunk states
    F_end = Fc[:, :, -1]                                      # (B,nc,H)
    ms = mc[:, :, -1]                                         # chunk-end stabilizer
    w_out = torch.exp(torch.clamp(F_end[:, :, None] - Fc + lic - ms[:, :, None], -60.0, 30.0))
    S_c = torch.einsum("bnsh,bnshk,bnshd->bnhkd", w_out, kc, vc)
    n_c = torch.einsum("bnsh,bnshk->bnhk", w_out, kc)

    # cross-chunk recurrence with precomputed scalar coefficients
    F_prev = torch.cat([torch.zeros_like(F_end[:, :1]), F_end[:, :-1]], dim=1)
    ms_prev = torch.cat([m0[:, None, :], ms[:, :-1]], dim=1)
    d = torch.exp(torch.clamp(F_end - F_prev + ms_prev - ms, -60.0, 30.0))   # (B,nc,H)
    C, n = C0, n0
    C_prevs, n_prevs = [], []
    for j in range(nc):
        C_prevs.append(C)
        n_prevs.append(n)
        C = C * d[:, j, :, None, None] + S_c[:, j]
        n = n * d[:, j, :, None] + n_c[:, j]
    C_prev = torch.stack(C_prevs, dim=1)                      # (B,nc,H,hd,hd)
    n_prev = torch.stack(n_prevs, dim=1)

    # inter-chunk contribution; F is a global cumsum: decay is F_t - F_prev
    w_state = torch.exp(torch.clamp(
        Fc - F_prev[:, :, None] + ms_prev[:, :, None] - mc, -60.0, 30.0))    # (B,nc,t,H)
    num_inter = w_state[..., None] * torch.einsum("bnthk,bnhkd->bnthd", qc, C_prev)
    den_inter = w_state * torch.einsum("bnthk,bnhk->bnth", qc, n_prev)

    den = torch.clamp((den_intra + den_inter).abs(), min=1.0)
    h = (num_intra + num_inter) / den[..., None]
    return h.reshape(B, S, H, hd), (C, n, m[:, -1])


def _gate_logs(gates: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The input and forget gates' logs from the gate pre-activations
    (..., 2H): the input gates as they are, the forget gates' logsigmoid."""
    H = gates.shape[-1] // 2
    return gates[..., :H], F.logsigmoid(gates[..., H:])


def _mlstm_local(q, k, v, gates, C0, n0, m0, chunk: int):
    """:func:`_mlstm_chunked` from the gate pre-activations (B,S,2,H), its
    outputs flat: ``(h, C, n, m)``."""
    h, state = _mlstm_chunked(q, k, v, *_gate_logs(gates.flatten(2)), C0, n0, m0, chunk)
    return (h, *state)


def _mlstm_step(q, k, v, gates, C0, n0, m0):
    """The recurrence for one token from the gate pre-activations
    (B,1,2,H): ``(h, C, n, m)``."""
    log_i, log_f = _gate_logs(gates.flatten(2))
    li, lf = log_i[:, 0], log_f[:, 0]                         # (B,H)
    m = torch.maximum(lf + m0, li)
    fp = torch.exp(lf + m0 - m)[:, :, None]
    ip = torch.exp(li - m)[:, :, None]
    kt, qt = k[:, 0].float(), q[:, 0].float()
    C = fp[..., None] * C0 + (ip * kt)[..., None] * v[:, 0].float()[:, :, None, :]
    n = fp * n0 + ip * kt
    num = torch.einsum("bhk,bhkv->bhv", qt, C)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", qt, n).abs(), min=1.0)
    return (num / den[..., None])[:, None], C, n, m


def _laid_out_as(q, state):
    """q (B,S,H,hd) laid out to run the cell on local shards: on each mesh
    dimension sharded on the state's rows or heads where a DTensor state
    (a cache) is, else on q's own rows."""
    if not (isinstance(state, DTensor) and any(p.is_shard() for p in state.placements)):
        return keep_shards(q, (0, 2))
    return q.redistribute(q.device_mesh, [Shard(2 * p.dim) if p.is_shard() else Replicate()
                                          for p in state.placements])


def _store(cache: Optional[dict], new: dict) -> dict:
    """``new`` written into ``cache`` in place (and ``cache`` returned), or
    ``new`` itself without a cache."""
    if cache is None:
        return new
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def mlstm_block(p: Params, x: torch.Tensor, cfg, *, cache: Optional[dict] = None):
    """x (B,S,D) → ``(out, state)``: the chunked-parallel form for S > 1,
    the recurrence for one token.  ``cache`` ``{"C", "n", "m"}`` is the
    incoming state (zeros and m = -1e30 without one), updated in place."""
    B, S, D = x.shape
    H, _ = _heads(cfg)
    d_up = p["w_up"].shape[1] // 2
    hd = d_up // H

    u, z = (x @ p["w_up"]).chunk(2, dim=-1)                   # (B,S,d_up)
    q, k, v = (u @ p["w_qkv"]).chunk(3, dim=-1)
    # JAX divides by sqrt(hd) rounded to the activation dtype
    root = torch.tensor(math.sqrt(hd), dtype=x.dtype).item()
    q = q.reshape(B, S, H, hd) / root
    k = k.reshape(B, S, H, hd) / root
    v = v.reshape(B, S, H, hd)
    gates = u.float() @ p["w_if"] + p["b_if"]                 # (B,S,2H)

    if cache is None:
        C0, n0, m0 = (replicate_like(t, x) for t in (
            torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device),
            torch.zeros((B, H, hd), dtype=torch.float32, device=x.device),
            torch.full((B, H), -1e30, dtype=torch.float32, device=x.device)))
    else:
        C0, n0, m0 = cache["C"], cache["n"], cache["m"]

    if S > 1:
        chunk = cfg.xlstm.mlstm_chunk
        while S % chunk:
            chunk //= 2
        core = functools.partial(_mlstm_local, chunk=chunk)
    else:                                                     # one recurrent step
        core = _mlstm_step
    gates = gates.reshape(B, S, 2, H)
    if isinstance(q, DTensor):
        # each device runs the cell on its own batch rows, and heads where
        # the state shards them: it is independent per row and head, and
        # DTensor has no rule for cummax (nor its backward's scatter_add)
        # and cannot always flatten the step's heads
        q = _laid_out_as(q, C0)
        hs, C, n, m = on_local_shards(
            core, q, HEADS, [(q, HEADS), (k, HEADS), (v, HEADS),
                             (gates, {"batch": 0, "heads": 3}),
                             (C0, STATE), (n0, STATE), (m0, STATE)],
            [HEADS, STATE, STATE, STATE])
    else:
        hs, C, n, m = core(q, k, v, gates, C0, n0, m0)
    h = hs.reshape(B, S, d_up).to(x.dtype)
    out = (h * F.silu(z)) @ p["w_down"]
    return out, _store(cache, {"C": C, "n": n, "m": m})


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_block(p: Params, x: torch.Tensor, cfg, *, cache: Optional[dict] = None):
    """x (B,S,D) → ``(out, state)``, stepping over the sequence (the gates
    read the previous h).  ``cache`` ``{"c", "n", "m", "h"}`` is the
    incoming state (c, m 0, n 1, h 0 without one), updated in place."""
    B, S, D = x.shape
    gx = x @ p["w_gates"]                                     # (B,S,4D)
    if cache is None:
        c, n, m, h = (replicate_like(t, x) for t in (
            torch.zeros((B, D), dtype=torch.float32, device=x.device),
            torch.ones((B, D), dtype=torch.float32, device=x.device),
            torch.zeros((B, D), dtype=torch.float32, device=x.device),
            torch.zeros((B, D), dtype=x.dtype, device=x.device)))
    else:
        c, n, m, h = cache["c"], cache["n"], cache["m"], cache["h"]
    args = (gx, p["r_gates"], p["b_gates"], c, n, m, h)
    if isinstance(gx, DTensor):
        # each device steps its own batch rows on plain tensors (a step of
        # DTensor ops costs the host far more than the step), the gate
        # inputs whole on their last axis, the recurrent weights and bias
        # gathered once rather than at every step
        gx = keep_shards(gx, (0,))
        hs, c, n, m, h = on_local_shards(_slstm_scan, gx, ROWS, list(zip(
            (gx,) + args[1:], (ROWS, {}, {}) + (ROWS,) * 4)), [ROWS] * 5)
    else:
        hs, c, n, m, h = _slstm_scan(*args)
    out = hs @ p["w_out"]
    return out, _store(cache, {"c": c, "n": n, "m": m, "h": h})


def _slstm_scan(gx, r_w, b, c, n, m, h):
    """The sLSTM recurrence over gx's S positions from state (c, n, m, h):
    returns the hidden states (B,S,D) and the last state."""
    hs = []
    for t in range(gx.shape[1]):
        gxt = gx[:, t]
        g = (gxt + h @ r_w).float() + b                       # (B,4D)
        li, lf, zt, ot = g.chunk(4, dim=-1)
        lf = F.logsigmoid(lf)
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li - m_new)
        c = fp * c + ip * torch.tanh(zt)
        n = fp * n + ip
        h = (torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)).to(gxt.dtype)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), c, n, m, h
