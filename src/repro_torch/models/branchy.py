"""Branchy NAS-style cells (paper's Table 1 regime).

A cell applies ``n_branches`` independent transforms to its input and joins
them — the exact inter-operator-parallel structure of NASNet/DARTS/AmoebaNet
that the paper's multi-stream execution accelerates.  The degree of logical
concurrency of the traced task graph equals ``n_branches`` (checked in
tests).  Parameters are a dict of float32 tensors with the JAX package's
names, so ``bridge.branchy_params_from_jax`` carries JAX weights over.
"""

from __future__ import annotations

import torch

from repro_torch.configs.branchy_cell import BranchyCellConfig


def init_branchy(generator: torch.Generator, cfg: BranchyCellConfig, *,
                 device="cuda") -> dict[str, torch.Tensor]:
    """Random weights drawn from ``generator`` (on its own device), moved to
    ``device``: the stem scaled by 0.05, each branch by 0.5 / n_branches."""

    def normal(scale: float) -> torch.Tensor:
        t = torch.randn((cfg.width, cfg.width), generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (t * scale).to(device)

    params = {"stem": normal(0.05)}
    for c in range(cfg.n_cells):
        for b in range(cfg.n_branches):
            params[f"c{c}b{b}"] = normal(0.5 / cfg.n_branches)
    return params


def branchy_forward(params: dict[str, torch.Tensor], x: torch.Tensor,
                    cfg: BranchyCellConfig) -> torch.Tensor:
    """x: (batch, width)."""
    x = torch.tanh(x @ params["stem"])
    for c in range(cfg.n_cells):
        branches = [
            torch.tanh(x @ params[f"c{c}b{b}"]) for b in range(cfg.n_branches)
        ]
        acc = branches[0]
        for br in branches[1:]:
            acc = acc + br
        x = x + acc
    return x


def example_input(cfg: BranchyCellConfig, seed: int = 0, *, device="cuda") -> torch.Tensor:
    """A (batch, width) float32 standard-normal input from ``seed``, drawn
    on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((cfg.batch, cfg.width), generator=g, device=device,
                       dtype=torch.float32)
