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

Under a mesh (DTensors) each device routes its own tokens, as JAX's
partitioned program does: no device gathers the global tokens or the
global expert outputs.  Capacity and drops stay JAX's global ones:

* the router, the gates and the slots run on the device's rows of x (its
  batch shard; tokens sharded on ``seq`` are refused), the router's
  weight gathered whole (it is small);
* a token's slot is its rank in its expert's run over the global token
  order: its rank among the device's tokens plus that expert's count on
  the shards before it (the ``(E,)`` counts all-gathered over the token
  shards), and ``capacity`` takes the global N;
* the aux loss takes the global mean: the probabilities' and the counts'
  sums over the token shards;
* each device scatters the tokens routed to its own experts (the
  ``expert`` layout of the capacity buffer) into a local
  ``(E_loc·cap + 1, D)`` buffer at their global slots, then sums it over
  the token shards: every slot has one writer, so the sum is exact, and
  every data shard holds its experts' whole buffer (JAX's
  ``constrain(buf, "expert", "_", "_")``);
* B2 runs on each device's local experts, and the combine gathers the
  ``(N_l, K, D)`` rows of the device's tokens from its own experts (zeros
  elsewhere), sums them over the expert shards (one nonzero an entry:
  exact) and only then weighs them and adds over K, in the single-process
  order.

The three steps are ``local_map`` regions apart (:func:`_region`), so that
x's gradient through the router (whole on every expert shard) and through
the dispatch (a partial sum over the expert shards) are each laid out as
what they are.  On a mesh whose dimensions each hold one device nothing is
communicated and every op is the single-process one.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import (all_gather_over, constrain, gather_fsdp, keep_shards,
                                     logical_to_pspec, placed_offset, placements_for, sum_over)
from repro_torch.distributed.sharding import current_ctx
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


class Routing(NamedTuple):
    """The router's decisions for the tokens in flat order ``n·K + k``:
    ``gates`` (N, K) float32 renormalised, ``experts``, ``slots`` (each
    assignment's rank in its expert's run over the global token order) and
    ``keep`` (``slots < cap``), all (N·K,), the aux loss and ``cap``.
    Under a mesh each is a DTensor sharded as the tokens (the aux loss
    replicated)."""

    gates: torch.Tensor
    experts: torch.Tensor
    slots: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    cap: int


def _route(xf, w, cfg, n_tokens: int, cap: int, groups: Sequence[str] = (), shard: int = 0):
    """Router, aux loss and slots on ``xf`` (n, D), the rows of shard
    ``shard`` (in the token order) of ``n_tokens``, whose shards are
    summed and gathered over the process groups ``groups`` (none: ``xf``
    is every token); ``cap`` slots an expert."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    logits = xf.float() @ w                                      # (n, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)         # (n, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    flat_e = expert_ids.reshape(-1)                              # (n*K,)
    ones = torch.ones_like(flat_e)
    counts = torch.zeros((E,), dtype=flat_e.dtype, device=xf.device).scatter_add_(0, flat_e, ones)

    # each token's rank within its expert's run: a stable sort keeps token
    # order within an expert, as the one-hot cumsum would
    order = torch.sort(flat_e, stable=True).indices
    starts = torch.cumsum(counts, 0) - counts                    # (E,)
    pos_in_run = torch.arange(flat_e.shape[0], device=xf.device) - starts[flat_e[order]]
    slot = torch.empty_like(flat_e).scatter_(0, order, pos_in_run)
    if groups:
        # the shards before this one come first in the global order
        every = all_gather_over(groups)(counts)                  # (shards, E)
        slot = slot + every[:shard].sum(0)[flat_e]
        counts = every.sum(0)
        me = sum_over(probs.sum(0), groups) / n_tokens
    else:
        me = probs.mean(dim=0)
    # aux load-balance loss (mean prob × token fraction per expert)
    ce = counts.float() / (n_tokens * K)
    aux = m.router_aux_loss * E * torch.sum(me * ce)
    return gate_vals, flat_e, slot, slot < cap, aux


def _own(flat_e, keep, first: int, n_experts: int, E: int):
    """``(local, kept, own)``: each assignment's expert less ``first``,
    ``keep`` of the assignments to experts ``[first, first + n_experts)``
    and which those are (None when they are all E)."""
    if n_experts == E:
        return flat_e, keep, None
    local = flat_e - first
    own = (local >= 0) & (local < n_experts)
    return local, keep & own, own


def _dispatch(xf, local, slot, kept, cap: int, n_experts: int,
              groups: Sequence[str] = ()) -> torch.Tensor:
    """The capacity buffer of ``n_experts`` experts as ``(n_experts, cap,
    D)``: the rows of ``xf`` (n, D) whose assignments are ``kept``, at
    their expert's (``local``) slots, summed over the process groups
    ``groups``."""
    n, D = xf.shape
    K = local.shape[0] // n
    # (n_experts*cap + 1, D): expert e's slots are rows [e*cap, (e+1)*cap),
    # the last row takes the dropped tokens (zeros) and is never read
    trash = n_experts * cap
    rows = torch.where(kept, local * cap + slot, trash)
    xk = xf.unsqueeze(1).expand(n, K, D).reshape(n * K, D)
    buf = torch.zeros((trash + 1, D), dtype=xf.dtype, device=xf.device)
    buf.index_put_((rows,), torch.where(kept[:, None], xk, 0))
    return sum_over(buf, groups)[:trash].view(n_experts, cap, D)


def _combine(eo, local, slot, keep, gates, own=None, groups: Sequence[str] = ()):
    """Each token's output (n, D) from the expert outputs ``eo``
    ``(n_experts, cap, D)``: its K rows (those of experts it does not
    ``own`` zeros, summed over the process groups ``groups``) weighed by
    its kept gates and added in order."""
    _, cap, D = eo.shape
    n, K = gates.shape
    idx = local * cap + slot.clamp(max=cap - 1)
    if own is None:
        gathered = eo.view(-1, D)[idx]                           # (n*K, D)
    else:
        gathered = eo.view(-1, D)[torch.where(own, idx, 0)].masked_fill_(~own[:, None], 0)
    gathered = sum_over(gathered, groups)
    weight = torch.where(keep, gates.reshape(-1), 0.0).to(eo.dtype)
    contrib = (gathered * weight[:, None]).view(n, K, D)
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    return out


def _experts(h, p, cfg):
    """The grouped expert FFN on the capacity buffer ``h`` (E, cap, D):
    one B2 launch per GEMM."""
    w_gate = gather_fsdp(p["w_gate"], "expert", "fsdp", "mlp", group="moe")
    w_up = gather_fsdp(p["w_up"], "expert", "fsdp", "mlp", group="moe")
    w_down = gather_fsdp(p["w_down"], "expert", "mlp", "fsdp", group="moe")
    g = _act(stream_pack(h, w_gate), cfg.activation)
    u = stream_pack(h, w_up)
    # B2 multiplies local shards only: its left operand is laid out first
    # (a partial sum reduced, an M-sharded one gathered)
    return constrain(stream_pack(constrain(g * u, "expert", "_", "mlp"), w_down),
                     "expert", "_", "_")


def _places(sharded, partial=()) -> tuple:
    """Placements: ``Shard(0)`` on the mesh dimensions ``sharded`` marks,
    ``Partial()`` on those ``partial`` marks, else ``Replicate()``."""
    partial = partial or (False,) * len(sharded)
    return tuple(Shard(0) if s else Partial() if g else Replicate()
                 for s, g in zip(sharded, partial))


class _Layout(NamedTuple):
    """Where a MoE layer's tensors lie on the mesh, per mesh dimension:
    ``tokens`` (x's batch shards) and ``experts`` (the capacity buffer's
    expert shards); the process groups of those of more than one device;
    this device's token shard (its index in the token order) and its
    experts ``[first_expert, first_expert + n_experts)``."""

    mesh: object
    tokens: tuple
    experts: tuple
    token_groups: tuple
    expert_groups: tuple
    token_shard: int
    first_expert: int
    n_experts: int


def _layout(x: DTensor, E: int, cap: int) -> tuple[DTensor, _Layout]:
    """``x`` with its batch shards kept (made whole on every other mesh
    dimension) and the layout of a MoE layer on its mesh: x's batch shards
    and the capacity buffer's ``expert`` shards under the sharding
    context's rules (none outside a context).  Tokens sharded on ``seq``
    are refused: the slots need the global token order ``b·S + s``, whose
    batch shards are contiguous."""
    if any(isinstance(p, Shard) and p.dim == 1 for p in x.placements):
        raise ValueError(f"MoE routing needs each device's tokens whole along seq: x "
                         f"{tuple(x.shape)} is laid out {x.placements}")
    x = keep_shards(x, (0,))
    mesh = x.device_mesh
    B, _, D = x.shape
    tokens = tuple(isinstance(p, Shard) for p in x.placements)
    ctx = current_ctx()
    experts = (False,) * mesh.ndim
    if ctx is not None:
        spec = logical_to_pspec(("expert", None, None), (E, cap, D), ctx.mesh, ctx.rules)
        experts = tuple(isinstance(p, Shard) for p in placements_for(spec, mesh))
    if any(t and e for t, e in zip(tokens, experts)):
        raise ValueError(f"a mesh dimension shards both the tokens and the experts: x "
                         f"{x.placements}, experts {experts}")
    size = [mesh.size(i) for i in range(mesh.ndim)]
    groups = [mesh.get_group(i).group_name if size[i] > 1 else None for i in range(mesh.ndim)]
    rows = B // math.prod(n for n, t in zip(size, tokens) if t)
    return x, _Layout(mesh, tokens, experts,
                      tuple(g for g, t in zip(groups, tokens) if t and g),
                      tuple(g for g, e in zip(groups, experts) if e and g),
                      placed_offset(mesh, _places(tokens), B, 0) // rows,
                      placed_offset(mesh, _places(experts), E, 0),
                      E // math.prod(n for n, e in zip(size, experts) if e))


def _region(fn, mesh, args, grads, outs):
    """``fn`` on each device's local tensors through ``local_map``:
    ``args`` are ``(value, placements)`` pairs (None for a value that is
    no tensor), ``grads`` the placements of the tensor arguments'
    gradients (None: their own), ``outs`` each output's placements."""
    in_p = tuple(p for _, p in args)
    in_g = tuple(g if g is not None else p for (_, p), g in zip(args, grads))
    return local_map(fn, out_placements=tuple(outs), in_placements=in_p,
                     in_grad_placements=in_g, device_mesh=mesh)(*(v for v, _ in args))


def route(p: Mapping, x: torch.Tensor, cfg) -> Routing:
    """The router's decisions for ``x`` (B, S, D): on a DTensor, each
    device's for its own tokens (see the module docstring)."""
    xd, lay = _tokens(x, cfg)
    return _routed(p, xd, cfg, lay)


def _tokens(x: torch.Tensor, cfg):
    """``(xd, layout)``: x as (N, D) tokens and, on a DTensor, laid out by
    :func:`_layout` with the layer's :class:`_Layout` (else None)."""
    B, S, D = x.shape
    lay = None
    if isinstance(x, DTensor):
        x, lay = _layout(x, cfg.moe.num_experts, capacity(B * S, cfg))
    return x.reshape(B * S, D), lay


def _routed(p: Mapping, xd: torch.Tensor, cfg, lay: _Layout | None) -> Routing:
    """:func:`route` of the tokens ``xd`` (N, D), on the local tokens
    under a layout."""
    N, D = xd.shape
    cap = capacity(N, cfg)
    if lay is None:
        return Routing(*_route(xd, p["router"], cfg, N, cap), cap)
    none = (False,) * lay.mesh.ndim
    tok, rep = _places(lay.tokens), _places(none)

    def fn(xl, w):
        return _route(xl, w, cfg, N, cap, lay.token_groups, lay.token_shard)

    # the router's weight, gathered whole: its gradient is each token
    # shard's share; x's is whole on every expert shard
    out = _region(fn, lay.mesh, [(xd, tok), (keep_shards(p["router"], ()), rep)],
                  [None, _places(none, lay.tokens)], [tok, tok, tok, tok, rep])
    return Routing(*out, cap)


def apply_moe(p: Mapping, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux_loss ())."""
    B, S, D = x.shape
    E = cfg.moe.num_experts
    # every use reads the one (N, D) view, so that x's gradient sums its
    # parts in the single-process order on a one-device mesh too
    xd, lay = _tokens(x, cfg)
    r = _routed(p, xd, cfg, lay)
    if lay is None:
        h = _dispatch(xd, r.experts, r.slots, r.keep, r.cap, E)
        eo = _experts(h, p, cfg)
        out = _combine(eo, r.experts, r.slots, r.keep, r.gates)
    else:
        tok, exp = _places(lay.tokens), _places(lay.experts)
        first, n_exp = lay.first_expert, lay.n_experts

        def dispatch(xl, flat_e, slot, keep):
            local, kept, _ = _own(flat_e, keep, first, n_exp, E)
            return _dispatch(xl, local, slot, kept, r.cap, n_exp, lay.token_groups)

        ints = [(r.experts, tok), (r.slots, tok), (r.keep, tok)]
        # x's gradient through the scatter: each expert shard's share
        h = _region(dispatch, lay.mesh, [(xd, tok)] + ints,
                    [_places(lay.tokens, lay.experts), None, None, None], [exp])
        eo = _experts(h, p, cfg)

        def combine(eol, flat_e, slot, keep, gates):
            local, _, own = _own(flat_e, keep, first, n_exp, E)
            return _combine(eol, local, slot, keep, gates, own, lay.expert_groups)

        # the expert outputs' gradient: each token shard's share
        out = _region(combine, lay.mesh, [(eo, exp)] + ints + [(r.gates, tok)],
                      [_places(lay.experts, lay.tokens), None, None, None, None], [tok])

    # ---- shared experts (DeepSeek) ---------------------------------------
    if "shared" in p:
        sh = p["shared"]
        sg = gather_fsdp(sh["w_gate"], "fsdp", "mlp", group="moe")
        su = gather_fsdp(sh["w_up"], "fsdp", "mlp", group="moe")
        sd = gather_fsdp(sh["w_down"], "mlp", "fsdp", group="moe")
        hs = _act(xd @ sg, cfg.activation) * (xd @ su)
        out = out + hs @ sd

    return out.reshape(B, S, D), r.aux
