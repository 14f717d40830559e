"""The port's CUDA-graph captures hold Python's garbage collector off.

An automatic collection inside a capture may free a reference cycle that
holds another CUDA graph (an earlier engine's sealed steps), and CUDA
refuses to destroy a graph while a stream captures, which ends the capture
in an error.  ``core.capture.capture_graph`` is the one capture context of
the port: it turns the collector off for the capture and gives back the
previous state on exit.  Here ``torch.cuda.graph`` and
``torch.cuda.CUDAGraph`` are stubs, so the context runs on the CPU; an AST
scan holds every capture under ``src/repro_torch/`` to it.
"""

import ast
import gc
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core import capture

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the port's captures: the engine's sealed steps, the sealed train step and
# a Nimble plan
SITES = ("serving/engine.py", "training/train_lib.py", "core/aot.py")
CAPTURES = ("torch.cuda.graph", "cuda.graph", "torch.cuda.graphs.graph")


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``."""


class _FakeCapture:
    """Stands in for ``torch.cuda.graph``: records its arguments and the
    collector's state when the capture begins and ends."""

    calls: list = []

    def __init__(self, graph, **kw):
        self.graph, self.kw = graph, kw

    def __enter__(self):
        _FakeCapture.calls.append(("enter", self.graph, self.kw, gc.isenabled()))
        return self

    def __exit__(self, *exc):
        _FakeCapture.calls.append(("exit", self.graph, self.kw, gc.isenabled()))
        return False


@pytest.fixture
def fake_cuda(monkeypatch):
    _FakeCapture.calls = []
    monkeypatch.setattr(torch.cuda, "graph", _FakeCapture)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    was = gc.isenabled()
    yield _FakeCapture.calls
    (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("before", [True, False], ids=["collector_on", "collector_off"])
def test_the_collector_is_off_inside_and_restored_after(fake_cuda, before):
    (gc.enable if before else gc.disable)()
    graph = torch.cuda.CUDAGraph()
    with capture.capture_graph(graph):
        assert not gc.isenabled()
    assert gc.isenabled() == before
    assert [c[0] for c in fake_cuda] == ["enter", "exit"]
    assert all(c[1] is graph and not c[3] for c in fake_cuda)


@pytest.mark.parametrize("before", [True, False], ids=["collector_on", "collector_off"])
def test_the_state_comes_back_after_an_exception(fake_cuda, before):
    (gc.enable if before else gc.disable)()
    with pytest.raises(RuntimeError, match="inside the capture"):
        with capture.capture_graph(torch.cuda.CUDAGraph()):
            assert not gc.isenabled()
            raise RuntimeError("raised inside the capture")
    assert gc.isenabled() == before
    assert [c[0] for c in fake_cuda] == ["enter", "exit"]


def test_the_state_comes_back_when_the_capture_itself_fails(fake_cuda, monkeypatch):
    """``torch.cuda.graph`` raising at entry (a capture CUDA refuses)."""

    class Refused(_FakeCapture):
        def __enter__(self):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "graph", Refused)
    gc.enable()
    with pytest.raises(RuntimeError, match="not permitted"):
        with capture.capture_graph(torch.cuda.CUDAGraph()):
            pass
    assert gc.isenabled()


def test_the_error_mode_is_the_ports(fake_cuda):
    with capture.capture_graph(torch.cuda.CUDAGraph()):
        pass
    assert capture.CAPTURE_ERROR_MODE == "thread_local"
    assert fake_cuda[0][2] == {"capture_error_mode": capture.CAPTURE_ERROR_MODE}


def test_other_arguments_reach_the_capture(fake_cuda):
    pool = object()
    with capture.capture_graph(torch.cuda.CUDAGraph(), capture_error_mode="global", pool=pool):
        pass
    assert fake_cuda[0][2] == {"capture_error_mode": "global", "pool": pool}


def test_a_cycle_dropped_inside_a_capture_is_not_collected_until_after(fake_cuda):
    """With the collector's first threshold at 1, any allocation would
    collect a dropped cycle at once; inside the capture none is collected,
    and an explicit collection after it frees the cycle."""
    freed = []

    class Holder:                       # an engine holding its graphs in a cycle
        def __del__(self):
            freed.append(True)

    threshold = gc.get_threshold()
    gc.enable()
    gc.set_threshold(1, *threshold[1:])
    try:
        with capture.capture_graph(torch.cuda.CUDAGraph()):
            h = Holder()
            h.me = h
            del h
            junk = [[i] for i in range(1000)]      # allocations that would collect
            assert not freed
        del junk
        gc.collect()
    finally:
        gc.set_threshold(*threshold)
    assert freed


def test_chip_smokes_capture_keeps_the_default_error_mode(fake_cuda):
    """``chip_smoke.capture`` delegates to the port's context in torch's
    default (global) mode, so its phases capture as before."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gc.enable()
    with smoke.capture(torch.cuda.CUDAGraph()):
        assert not gc.isenabled()
    assert gc.isenabled() and fake_cuda[0][2] == {"capture_error_mode": "global"}


# ---------------------------------------------------------------------------
# every capture of the port goes through the context
# ---------------------------------------------------------------------------

def _calls(path: Path):
    """Dotted names of every call in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Call):
            parts, f = [], node.func
            while isinstance(f, ast.Attribute):
                parts.append(f.attr)
                f = f.value
            if isinstance(f, ast.Name):
                parts.append(f.id)
            yield ".".join(reversed(parts))


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(PORT)))
def test_no_module_captures_outside_the_context(path):
    graphs = [c for c in _calls(path) if c in CAPTURES]
    tree = ast.parse(path.read_text(), filename=str(path))
    graphs += [f"from {n.module} import {a.name}" for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and (n.module or "").startswith("torch.cuda")
               for a in n.names if a.name == "graph"]
    if path == PORT / "core" / "capture.py":
        assert graphs == ["torch.cuda.graph"]
    else:
        assert not graphs, f"{path.relative_to(PORT)} calls {graphs}"


@pytest.mark.parametrize("site", SITES)
def test_each_capture_site_uses_the_context(site):
    calls = list(_calls(PORT / site))
    assert any(c.endswith("capture_graph") for c in calls), f"{site} does not call capture_graph"
