"""Training step: loss, gradients, AdamW, sealed as one CUDA graph.

The counterpart of the JAX package's ``training/train_lib.py``.  The whole
step (forward, backward, clipping and the AdamW update) is one function
over the model's parameters, so :func:`seal_train_step` captures it as one
``torch.cuda.CUDAGraph`` and the loop only copies a batch in and replays
(paper §5.3: Nimble supports training by capturing the whole iteration).

Differences from JAX, each for the capture or for memory at full width:

* gradients come from ``torch.autograd.grad(loss, params)``, functional
  like ``jax.value_and_grad``: no ``.grad`` fields accumulate across
  replays;
* the step updates the parameters, the moments and the step counter **in
  place** and returns them (JAX returns new trees); ``lr`` may be a
  function of the step counter, a device tensor, so a replay reads it
  afresh;
* the metrics are device tensors; reading one (``float(m["loss"])``)
  waits for the step.

Under a mesh (``make_train_step(..., mesh=)``, the parameters DTensors
placed by ``repro_torch.distributed.shard_model``) the step runs under
that sharding context: each gradient is laid out as its parameter (the
data-parallel reduction), the global norm and the clip sum every shard,
AdamW updates each device's shards in place, and the metrics come back
replicated.  :func:`seal_train_step` captures that step as one CUDA graph
too (its collectives with it).
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import torch
import torch.utils.checkpoint as ckpt
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.core.capture import CAPTURE_LOCK, capture_graph
from repro_torch.data import shard_batch
from repro_torch.distributed import (keep_shards, local_part, on_local_shards, replicate_like,
                                     shard_groups, shard_offset, use_sharding_ctx)
from repro_torch.kernels.cross_entropy import token_nll
from repro_torch.models import forward
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import AdamWState

# the batch rows of a (B, S, ...) tensor, and its batch rows and vocabulary
# columns (the logits), for the loss on each device's shards
_ROWS = {"batch": 0}
_LOGITS = {"batch": 0, "vocab": 2}


def _row_nll(logits: torch.Tensor, labels: torch.Tensor, start: int = 0,
             vocab: int | None = None, groups: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's summed token cross-entropy and its count of labelled
    tokens (label < 0 is masked out): two (B,) float32 tensors.  ``logits``
    may be one shard of the vocabulary, the columns from ``start`` of
    ``vocab``, its partials reduced over the process groups ``groups``
    (B5, ``kernels/cross_entropy``)."""
    nll = token_nll(logits, labels, start, vocab, groups)
    mask = (labels >= 0).float()
    return (nll * mask).sum(dim=-1), mask.sum(dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; label < 0 positions are masked out."""
    if isinstance(logits, DTensor):
        # each device's rows and vocabulary columns, as XLA reduces a
        # sharded softmax: per-row partials all-reduced over the
        # vocabulary's mesh axis, the logits never gathered
        logits = keep_shards(logits, tuple(_LOGITS.values()))
        vocab = logits.shape[-1]
        fn = functools.partial(_row_nll, start=shard_offset(logits, 2), vocab=vocab,
                               groups=shard_groups(logits, 2))
        nll, count = on_local_shards(fn, logits, _LOGITS,
                                     [(logits, _LOGITS), (labels, _ROWS)], [_ROWS, _ROWS])
    else:
        nll, count = _row_nll(logits, labels)
    return torch.sum(nll) / torch.clamp(torch.sum(count), min=1.0)


def make_loss_fn(cfg) -> Callable:
    """``loss_fn(model, batch) -> (loss, {"ce", "aux"})``."""

    def loss_fn(model, batch):
        logits, aux = forward(model, batch, cfg)
        labels = batch["labels"]
        if cfg.family == "vlm":
            # image positions carry no next-token loss
            pad = -torch.ones((labels.shape[0], cfg.vision_tokens), dtype=labels.dtype,
                              device=labels.device)
            labels = torch.cat([replicate_like(pad, labels), labels], dim=1)
        loss = cross_entropy(logits, labels) + aux["aux_loss"]
        return loss, {"ce": loss - aux["aux_loss"], "aux": aux["aux_loss"]}

    return loss_fn


def trainable(model) -> dict[str, torch.nn.Parameter]:
    """The model's parameters by name, each set to require grad (the port
    builds models for serving, with ``requires_grad`` off)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def _as_param(g: torch.Tensor | None, p: torch.Tensor) -> torch.Tensor:
    """A parameter's gradient laid out as the parameter (zeros if it has
    none): a DTensor gradient may come back partial (summed over the data
    axis) or otherwise placed.  A parameter the loss does not reach gets
    zeros, as ``jax.grad`` gives it, and AdamW still updates it: its
    moments decay and its weight decays.  Skipping such leaves would save
    B4 a pass over them but change the optimizer's state."""
    if g is None:
        return torch.zeros_like(p)
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _replicated(t: torch.Tensor) -> torch.Tensor:
    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return t


def make_train_step(
    cfg,
    *,
    lr: float | Callable = 3e-4,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    remat: bool = False,
    mesh=None,
    rules=None,
) -> Callable:
    """Returns ``step(model, opt_state, batch) -> (model, opt_state,
    metrics)``, updating the model's parameters and ``opt_state`` in place.
    ``step.loss_and_grads(model, batch)`` is its first half alone, which
    moves no state (a capture's warm-up).  ``remat`` recomputes the whole
    forward in the backward (``torch.utils.checkpoint``, JAX's
    ``jax.checkpoint`` of the loss).  With ``mesh`` both run under
    ``use_sharding_ctx(mesh, rules)``, over a model and a batch placed on
    it."""
    loss_fn = make_loss_fn(cfg)

    def loss_and_grads(model, batch):
        params = trainable(model)
        with use_sharding_ctx(mesh, rules), torch.enable_grad():
            if remat:
                loss, parts = ckpt.checkpoint(loss_fn, model, batch, use_reentrant=False,
                                              preserve_rng_state=False)
            else:
                loss, parts = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {name: _as_param(g, p) for (name, p), g in zip(params.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads, params

    def step(model, opt_state: AdamWState, batch):
        loss, parts, grads, params = loss_and_grads(model, batch)
        lr_val = lr(opt_state.step) if callable(lr) else lr
        with use_sharding_ctx(mesh, rules):
            _, opt_state, gnorm = adamw_update(
                grads, opt_state, params,
                lr=lr_val, weight_decay=weight_decay, max_grad_norm=max_grad_norm,
            )
        metrics = {
            "loss": loss,
            "ce": parts["ce"],
            "aux": parts["aux"],
            "grad_norm": gnorm,
            # a fill, not a host-to-device copy: capturable
            "lr": lr_val.float() if isinstance(lr_val, torch.Tensor)
            else replicate_like(torch.full((), float(lr_val), device=loss.device), loss),
        }
        return model, opt_state, {k: _replicated(v) for k, v in metrics.items()}

    step.loss_and_grads = loss_and_grads
    return step


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch (``data.SyntheticLM``) as tensors on ``device``: token
    ids and labels as int64, the rest as float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device, torch.long if not t.is_floating_point() else torch.float32)
    return out


class SealedTrainStep:
    """A training step over fixed model, optimizer state and batch buffers.

    ``sealed(batch)`` copies ``batch`` (numpy or tensors) into the static
    batch buffers (``sealed()`` reuses what they hold) and runs the step: a
    replay of the captured CUDA graph on the card, the eager step on the
    CPU.  Returns the metrics, the graph's own output tensors on the card
    (overwritten by the next replay)."""

    def __init__(self, step, model, opt_state, batch: dict):
        self.step, self.model, self.opt_state = step, model, opt_state
        first = next(model.parameters())
        device = first.device
        if isinstance(first, DTensor):      # the batch laid out on the parameters' mesh
            self.static = shard_batch(batch, first.device_mesh, device)
        else:
            self.static = batch_to_device(batch, device)
        self.graph = None
        self.metrics = None
        self.seal_s = 0.0
        if device.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        with torch.cuda.device(self.static["tokens"].device), CAPTURE_LOCK.capturing():
            # warm up loss and grads on a side stream: it builds the kernels,
            # opts them into their shared memory and runs every lazy
            # initialisation, and moves neither parameters nor moments
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.step.loss_and_grads(self.model, self.static)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            # the eager warm-up's blocks go back to the card, so that they
            # and the graph's pool do not both hold the step's memory
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            with capture_graph(graph):
                _, _, metrics = self.step(self.model, self.opt_state, self.static)
            torch.cuda.synchronize()
        self.graph, self.metrics = graph, metrics
        self.seal_s = time.perf_counter() - t0

    def __call__(self, batch: dict | None = None) -> dict:
        if batch is not None:
            for k, buf in self.static.items():
                new = torch.as_tensor(batch[k])
                if isinstance(buf, DTensor):        # this process's slice of the batch
                    buf, new = buf.to_local(), local_part(new, buf.device_mesh, buf.placements)
                buf.copy_(new)
        if self.graph is None:
            return self.step(self.model, self.opt_state, self.static)[2]
        self.graph.replay()
        return self.metrics


def seal_train_step(step, model, opt_state, batch: dict) -> SealedTrainStep:
    """Seal ``step`` (from :func:`make_train_step`) over ``model``,
    ``opt_state`` and buffers shaped like ``batch``: on CUDA, the forward,
    backward, clipping and AdamW update captured as one
    ``torch.cuda.CUDAGraph`` (holding ``CAPTURE_LOCK`` exclusively; the
    warm-up runs loss and grads only, so the state is as it was); on the
    CPU, the eager step over the same buffers."""
    return SealedTrainStep(step, model, opt_state, batch)
