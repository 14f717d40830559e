"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Counterpart of the JAX package's ``models/moe.py``, step for step: a
float32 router with top-k gates renormalised, the Shazeer-style aux loss,
a per-expert capacity (dropless when N <= 64), slots from a stable sort by
expert, the tokens scattered into a capacity buffer, the three grouped
expert GEMMs, the combine and, for DeepSeek-V2, the shared experts.  The E
experts are the paper's parallel branches; their GEMMs run as one launch
each of ``stream_pack`` (B2 on CUDA tensors, its plain version on CPU
tensors), where JAX uses ``einsum``.

Everything is static-shaped and free of host syncs (no ``nonzero``, no
boolean indexing, no ``.item()``), so a CUDA graph captures the dispatch.
Where the port differs from JAX in form, not in value:

* the capacity buffer is ``(E·cap + 1, D)`` with the trash row last, not
  ``(E, cap + 1, D)``: its first ``E·cap`` rows are the ``(E, cap, D)``
  operand of B2 with no copy;
* the combine adds each token's K contributions in order over a
  ``(N, K, D)`` view, as JAX's scatter-add into zeros does, with no atomics.

The sharding hints stand where JAX has them.  Under a mesh (DTensors) the
routing, the capacity dispatch and the combine see the global tokens, as
JAX's do, on replicated local tensors (:func:`_whole`: the tokens are
gathered over the data axis first), so capacity and drops are the
single-process step's; the capacity buffer is constrained on ``expert``
and the three B2 GEMMs run on each device's local experts.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed import constrain, gather_fsdp, replicate_like
from repro_torch.kernels.stream_pack import stream_pack

from .layers import Shape, _act


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert for ``n_tokens`` routed tokens: all of them when
    N <= 64 (decode steps and small prompts run dropless), else
    ``max(K, round(N·K/E · capacity_factor))``.  Python's ``round`` rounds
    half to even, as JAX's does on the host."""
    m = cfg.moe
    if n_tokens <= 64:
        return n_tokens
    return int(max(m.top_k, round(n_tokens * m.top_k / m.num_experts * m.capacity_factor)))


def moe_shapes(cfg) -> dict[str, Shape]:
    """Leaf name → shape and logical axes of one layer's MoE parameters, as
    ``init_moe`` makes them in JAX: ``router`` (D, E), ``w_gate``/``w_up``
    (E, D, F), ``w_down`` (E, F, D) and, with shared experts, ``shared.*``."""
    m, d = cfg.moe, cfg.d_model
    E, F_ = m.num_experts, m.d_ff_expert
    shapes = {
        "router": Shape((d, E), "fsdp _"),
        "w_gate": Shape((E, d, F_), "expert fsdp mlp"),
        "w_up": Shape((E, d, F_), "expert fsdp mlp"),
        "w_down": Shape((E, F_, d), "expert mlp fsdp"),
    }
    if m.num_shared_experts:
        f_sh = m.d_ff_shared * m.num_shared_experts
        shapes.update({"shared.w_gate": Shape((d, f_sh), "fsdp mlp"),
                       "shared.w_up": Shape((d, f_sh), "fsdp mlp"),
                       "shared.w_down": Shape((f_sh, d), "mlp fsdp")})
    return shapes


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor, the same on every device
    (gathered where it is sharded); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim).to_local()


def apply_moe(p: Mapping, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux_loss ())."""
    m = cfg.moe
    B, S, D = x.shape
    N = B * S
    E, K = m.num_experts, m.top_k
    xd = x.reshape(N, D)
    xf = _whole(xd)                                              # every token
    dev = x.device

    # ---- router --------------------------------------------------------
    logits = xf.float() @ _whole(p["router"])                   # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)         # (N, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # aux load-balance loss (mean prob × token fraction per expert)
    flat_e = expert_ids.reshape(-1)                              # (N*K,)
    me = probs.mean(dim=0)
    ones = torch.ones_like(flat_e)
    counts = torch.zeros((E,), dtype=flat_e.dtype, device=dev).scatter_add_(0, flat_e, ones)
    ce = counts.float() / (N * K)
    aux = m.router_aux_loss * E * torch.sum(me * ce)

    # ---- capacity-based dispatch (sort-based) -----------------------------
    cap = capacity(N, cfg)
    # each token's rank within its expert's run: a stable sort keeps token
    # order within an expert, as the one-hot cumsum would
    order = torch.sort(flat_e, stable=True).indices
    starts = torch.cumsum(counts, 0) - counts                    # (E,)
    pos_in_run = torch.arange(N * K, device=dev) - starts[flat_e[order]]
    slot = torch.empty_like(flat_e).scatter_(0, order, pos_in_run)
    keep = slot < cap

    # (E*cap + 1, D): expert e's slots are rows [e*cap, (e+1)*cap), the
    # last row takes the dropped tokens (zeros) and is never read
    trash = E * cap
    rows = torch.where(keep, flat_e * cap + slot, trash)
    xk = xf.unsqueeze(1).expand(N, K, D).reshape(N * K, D)
    buf = torch.zeros((trash + 1, D), dtype=x.dtype, device=dev)
    buf.index_put_((rows,), torch.where(keep[:, None], xk, 0))
    h = constrain(replicate_like(buf, x)[:trash].view(E, cap, D), "expert", "_", "_")

    # ---- grouped expert FFN: one B2 launch per GEMM ----------------------
    w_gate = gather_fsdp(p["w_gate"], "expert", "fsdp", "mlp", group="moe")
    w_up = gather_fsdp(p["w_up"], "expert", "fsdp", "mlp", group="moe")
    w_down = gather_fsdp(p["w_down"], "expert", "mlp", "fsdp", group="moe")
    g = _act(stream_pack(h, w_gate), cfg.activation)
    u = stream_pack(h, w_up)
    # B2 multiplies local shards only: its left operand is laid out first
    # (a partial sum reduced, an M-sharded one gathered)
    eo = constrain(stream_pack(constrain(g * u, "expert", "_", "mlp"), w_down),
                   "expert", "_", "_")
    eo = _whole(eo).view(trash, D)                               # (E*cap, D)

    # ---- combine back ----------------------------------------------------
    gathered = eo[flat_e * cap + slot.clamp(max=cap - 1)]        # (N*K, D)
    weight = torch.where(keep, gate_vals.reshape(-1), 0.0).to(x.dtype)
    contrib = (gathered * weight[:, None]).view(N, K, D)
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]

    out = replicate_like(out, x)
    aux = replicate_like(aux, x)

    # ---- shared experts (DeepSeek) ---------------------------------------
    if "shared" in p:
        sh = p["shared"]
        sg = gather_fsdp(sh["w_gate"], "fsdp", "mlp", group="moe")
        su = gather_fsdp(sh["w_up"], "fsdp", "mlp", group="moe")
        sd = gather_fsdp(sh["w_down"], "mlp", "fsdp", group="moe")
        hs = _act(xd @ sg, cfg.activation) * (xd @ su)
        out = out + hs @ sd

    return out.reshape(B, S, D), aux
