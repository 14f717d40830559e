"""Assigned input shapes, and meta-device stand-ins for every model input.

The JAX package's ``configs/shapes.py``: ``input_specs(cfg, shape_name)``
returns ``(step_kind, specs)`` where specs hold tensors on the meta device
(the port's ``ShapeDtypeStruct``: shape and dtype, nothing allocated),
which is what the dry run (``launch/dryrun.py``) runs the step on.

Decode shapes run ``decode_step`` (one new token against a cache of
``seq_len``, synchronized: ``init_cache(per_slot=False)``), not the train
step.  ``long_500k`` applies only to sub-quadratic archs.  Token and label
ids are int64, the port's index type, where JAX's are int32.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import init_cache

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# long_500k runs only on sub-quadratic archs (per spec); decode shapes are
# skipped for encoder-only archs (none assigned here).
LONG_CONTEXT_ARCHS = {"gemma2-27b", "zamba2-2.7b", "xlstm-125m"}


def applicable(cfg: ModelConfig, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.name in LONG_CONTEXT_ARCHS
    return True


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str | InputShape) -> tuple[str, dict]:
    """Meta-device stand-ins for the step function's data arguments:
    ``{"batch": {...}}`` for train and prefill, ``{"cache": ..., "tokens":
    ...}`` for decode; ``shape_name`` names an assigned shape, or is one."""
    sh = shape_name if isinstance(shape_name, InputShape) else INPUT_SHAPES[shape_name]
    B, S = sh.global_batch, sh.seq_len

    if sh.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            batch = {
                "tokens": _meta((B, S - cfg.vision_tokens), torch.int64),
                "vision_embeds": _meta((B, cfg.vision_tokens, cfg.vision_dim), torch.bfloat16),
            }
        elif cfg.family == "audio":
            batch = {
                "tokens": _meta((B, S), torch.int64),
                "frames": _meta((B, S // cfg.audio_frames_ratio, cfg.audio_dim), torch.bfloat16),
            }
        else:
            batch = {"tokens": _meta((B, S), torch.int64)}
        if sh.kind == "train":
            # labels shape matches tokens; VLM masks image positions internally
            batch["labels"] = _meta(batch["tokens"].shape, torch.int64)
        return sh.kind, {"batch": batch}

    # decode: a cache of seq_len and one token (synchronized batch decode:
    # one scalar write offset)
    mem_len = S // cfg.audio_frames_ratio if cfg.family == "audio" else 0
    cache = init_cache(cfg, B, max_len=S, memory_len=mem_len, per_slot=False, device="meta")
    return "decode", {"cache": cache, "tokens": _meta((B, 1), torch.int64)}
