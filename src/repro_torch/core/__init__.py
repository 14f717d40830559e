"""Nimble's core: task graphs, stream assignment, AoT scheduling, engines."""

from .aot import AoTScheduler, Nimble, ScheduleKey, ScheduleStats, TaskSchedule
from .engine import DispatchProfile, EagerInterpreter, JitPerOpEngine, compare_engines
from .graph import Task, TaskGraph
from .matching import ford_fulkerson, hopcroft_karp
from .meg import minimum_equivalent_graph
from .memory import BufferSpec, MemoryPlan, buffers_from_traced, plan_memory
from .rewriter import PackReport, pack_streams_fn, plan_packs
from .streams import StreamAssignment, assign_streams
from .trace import TracedGraph, trace_to_taskgraph

__all__ = [
    "AoTScheduler", "Nimble", "ScheduleKey", "ScheduleStats", "TaskSchedule",
    "DispatchProfile", "EagerInterpreter", "JitPerOpEngine", "compare_engines",
    "Task", "TaskGraph",
    "ford_fulkerson", "hopcroft_karp",
    "minimum_equivalent_graph",
    "BufferSpec", "MemoryPlan", "buffers_from_traced", "plan_memory",
    "PackReport", "pack_streams_fn", "plan_packs",
    "StreamAssignment", "assign_streams",
    "TracedGraph", "trace_to_taskgraph",
]
