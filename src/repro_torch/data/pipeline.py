"""Synthetic LM data pipeline: deterministic, sharded, prefetching.

A copy of the JAX package's ``data/pipeline.py`` (numpy): its batches equal
the JAX package's bit for bit, step by step and shard by shard.  The
trainer copies each batch into its device buffers.  Sharded execution adds
:func:`shard_batch`: every process draws the same global batch from the
seed and keeps its slice on the data axis, so a sharded step sees exactly
the single-process batch.

Generates reproducible token streams with a power-law unigram distribution
plus a deterministic n-gram-ish structure (so a model can actually reduce
loss — pure uniform noise has nothing to learn).  Host-side numpy generation
with a background prefetch thread, sharded per data-parallel rank.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.distributed import batch_axes, shard_tree


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_size: int               # per-host batch
    seed: int = 0
    structure_order: int = 2      # markov order of the synthetic structure
    family: str = "dense"
    vision_tokens: int = 0
    vision_dim: int = 0
    audio_frames_ratio: int = 0
    audio_dim: int = 0


class SyntheticLM:
    """Deterministic synthetic corpus.

    Token t+1 is drawn from a mixture of a global power-law unigram and a
    deterministic permutation of token t (learnable bigram structure).
    """

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks**1.1)
        self.unigram /= self.unigram.sum()
        self.perm = root.permutation(v)          # the learnable structure
        self.mix = 0.7                            # P(follow structure)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * self.num_shards + self.shard
        )
        B, S = cfg.batch_size, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab, size=B, p=self.unigram)
        structure = rng.random((B, S)) < self.mix
        noise = rng.choice(cfg.vocab, size=(B, S), p=self.unigram)
        for t in range(S):
            follow = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(structure[:, t], follow, noise[:, t])
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "vlm":
            out["vision_embeds"] = rng.standard_normal(
                (B, cfg.vision_tokens, cfg.vision_dim)
            ).astype(np.float32)
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (B, S // cfg.audio_frames_ratio, cfg.audio_dim)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (double buffering) over a batch source."""

    def __init__(self, source: SyntheticLM, depth: int = 2, start_step: int = 0):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put(self.source.batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self) -> dict:
        return self.q.get()

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def data_config_for(model_cfg, *, batch_size: int, seq_len: int, seed: int = 0) -> DataConfig:
    return DataConfig(
        vocab=model_cfg.vocab,
        seq_len=seq_len,
        batch_size=batch_size,
        seed=seed,
        family=model_cfg.family,
        vision_tokens=model_cfg.vision_tokens,
        vision_dim=model_cfg.vision_dim,
        audio_frames_ratio=model_cfg.audio_frames_ratio,
        audio_dim=model_cfg.audio_dim,
    )


def shard_batch(batch: dict, mesh, device, rules=None) -> dict:
    """A global batch (numpy or tensors, the same on every process) as
    DTensors on ``mesh``, laid out by their logical axes
    (``repro_torch.distributed.batch_axes``: token ids and labels ``Shard(0)``
    on the data axis): each process holds its slice on ``device``, token
    ids and labels as int64, the rest as float32."""
    full = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        full[k] = t.to(device, torch.long if not t.is_floating_point() else torch.float32)
    return shard_tree(full, batch_axes(full), mesh, rules)
