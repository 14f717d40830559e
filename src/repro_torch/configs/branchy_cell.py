"""Branchy NAS-style cell — the paper's own evaluation regime (NASNet/DARTS/
AmoebaNet are branchy DAG cells; paper Table 1 correlates multi-stream speedup
with the cell's degree of logical concurrency).  A copy of the JAX
package's configs; the port drives them through ``Nimble`` in
``chip_smoke.py``.  Not part of the assigned-architecture pool."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class BranchyCellConfig:
    name: str
    n_cells: int          # stacked cells (like NASNet stacked cells)
    n_branches: int       # parallel ops per cell = degree of concurrency
    width: int            # feature width per branch
    batch: int


def darts_like() -> BranchyCellConfig:
    return BranchyCellConfig(name="darts-like", n_cells=4, n_branches=7, width=64, batch=8)


def nasnet_mobile_like() -> BranchyCellConfig:
    return BranchyCellConfig(name="nasnet-m-like", n_cells=4, n_branches=12, width=48, batch=8)


def amoebanet_like() -> BranchyCellConfig:
    return BranchyCellConfig(name="amoebanet-like", n_cells=4, n_branches=11, width=56, batch=8)


def inception_like() -> BranchyCellConfig:
    return BranchyCellConfig(name="inception-like", n_cells=4, n_branches=6, width=96, batch=8)
