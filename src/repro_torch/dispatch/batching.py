"""Cross-tenant batch composer: coalesce compatible lanes into one engine.

Nimble's AoT scheduling makes the per-step dispatch nearly free, but a
granted quantum still steps ONE tenant's engine — at per-lane occupancy 1
the device runs a batch of one per step, and tokens/s is bounded by lane
count, not device throughput.  This module adds the iteration-level
continuous-batching layer (the vLLM-style slot model, made cheap by the
repo's fixed-per-bucket sealed schedules: the executable never changes,
only slot *contents* do): lanes whose engines would compile the **same**
executables — same config, weights, device, slot count, and bucketing
policy, as witnessed by ``ServingEngine.compose_key()`` — form a
:class:`ComposeGroup` that shares one *host* engine.  One device step of
the host decodes every member's in-flight sequences at once, with
**per-slot tenancy**: each occupied slot is tagged with its owning lane
(``Request.model``), and freed slots are refilled from member lane queues
in fairness-policy order.

Division of labor:

* this module owns group *membership* (who shares a host, which engine
  hosts) and advisory peeks (``lane_busy``, ``occupancy``);
* :meth:`Dispatcher.step_group` owns the composed step itself — refill,
  the host ``engine.step()``, per-lane token attribution, fairness
  charging, and completion routing;
* the ``_QuantumArbiter`` group-grant path (``acquire_group``) lets one
  worker claim every co-member's quantum so a composed step never races
  a solo step of the same host.

Single-stepper contract: the host engine is only ever stepped under the
group's ``step_mu`` (``Dispatcher.step_lane`` delegates every composed
lane to ``step_group``), so N lanes sharing a host still mean exactly one
stepper in the host at a time.

Retirement: unregistering a non-host member just drains its queue/slots
through the host and leaves.  Unregistering the HOST lane disbands the
group — :meth:`BatchComposer.begin_retire` pauses refill for everyone
except the retiring lane, the drain loop runs the host dry (bounded by
``max_new_tokens`` per slot), and :meth:`BatchComposer.finish_retire`
re-forms the survivors around a fresh host.  Members' queued work waits
out the disband; nothing is lost.

Thread-safety: the composer's one mutex guards membership only and is a
leaf lock (nothing is called while holding it); ``ComposeGroup.step_mu``
is held across the composed engine step and nests *above* lane queue
locks and the fairness lock, exactly like the per-lane ``step_mu`` it
replaces for composed lanes.
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class ComposeGroup:
    """Lanes sharing one batched-decode host engine.

    ``host`` is the engine every member's requests are seated in (the
    first member's engine at formation time); ``host_lane`` its owning
    lane name; ``lanes`` the member names in join order (mutated only
    under the owning composer's mutex — readers take snapshots via
    :meth:`BatchComposer.members`).  ``step_mu`` serializes composed
    stepping of the host: it replaces the per-lane ``step_mu`` for every
    member, which is what upholds the engine's single-stepper contract
    when N lanes share the host.  ``retiring`` names the lane currently
    disbanding the group (refill is then restricted to that lane so the
    host can drain), or ``None``.
    """

    __slots__ = ("key", "host_lane", "host", "lanes", "step_mu", "retiring")

    def __init__(self, key: Any, host_lane: str, host: Any) -> None:
        self.key = key
        self.host_lane = host_lane
        self.host = host
        self.lanes: list[str] = [host_lane]
        self.step_mu = threading.Lock()
        self.retiring: Optional[str] = None

    def occupancy(self) -> dict:
        """Live host slots per owning lane (``{lane: count}``) — a
        lock-free advisory peek (list reads are atomic); slot ownership is
        the seated request's ``model``, falling back to the host lane for
        requests submitted to the engine directly."""
        out: dict[str, int] = {}
        for req in list(self.host.slots):
            if req is not None:
                owner = getattr(req, "model", "") or self.host_lane
                out[owner] = out.get(owner, 0) + 1
        return out


class BatchComposer:
    """Membership registry grouping compatible lanes onto shared hosts.

    Pass one to :class:`~repro_torch.dispatch.Dispatcher` (or through
    ``AsyncDispatcher(composer=...)``) to opt serving into cross-tenant
    batched decode.  ``register_model`` calls :meth:`add_lane`; lanes
    whose engines expose a ``compose_key()`` (``ServingEngine`` does) and
    agree on it share a :class:`ComposeGroup`; engines without one are
    never composed and keep the solo step path.  Compatibility is exact
    by construction: equal keys mean the same model config, the same
    weights object, the same device placement, the same slot count and
    context length, and the same bucketing policy — i.e. the engines
    would build byte-identical executables, so any member's request can
    seat in the host without changing the sealed schedule.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()                # membership only; leaf
        self._groups: dict[Any, ComposeGroup] = {}   # compose key -> group
        self._by_lane: dict[str, ComposeGroup] = {}
        self._engines: dict[str, Any] = {}         # lane -> its own engine

    @staticmethod
    def _key_of(engine: Any) -> Optional[Any]:
        fn = getattr(engine, "compose_key", None)
        if fn is None:
            return None
        return fn()

    def add_lane(self, name: str, engine: Any) -> Optional[ComposeGroup]:
        """Join ``name`` to the group for its engine's compose key,
        forming one (with ``engine`` as host) if none exists.  Returns the
        group, or ``None`` when the engine is not composable (no
        ``compose_key()``)."""
        key = self._key_of(engine)
        if key is None:
            return None
        with self._mu:
            return self._add_locked(name, engine, key)

    def _add_locked(self, name: str, engine: Any, key: Any) -> ComposeGroup:
        group = self._groups.get(key)
        if group is None:
            group = ComposeGroup(key, name, engine)
            self._groups[key] = group
        elif name not in group.lanes:
            group.lanes.append(name)
        self._by_lane[name] = group
        self._engines[name] = engine
        return group

    def group_of(self, name: str) -> Optional[ComposeGroup]:
        """The group ``name`` belongs to, or ``None`` (not composed)."""
        with self._mu:
            return self._by_lane.get(name)

    def members(self, name: str) -> list[str]:
        """Snapshot of ``name``'s group members in join order (including
        ``name`` itself); empty when the lane is not composed."""
        with self._mu:
            group = self._by_lane.get(name)
            return list(group.lanes) if group is not None else []

    def lane_busy(self, name: str) -> bool:
        """Whether ``name`` has work living in its group's HOST engine —
        seated slots or engine-queued admissions tagged with the lane.
        This is the activity term the lane's own ``engine.idle`` cannot
        see (a member's in-flight sequences run in the host, not in its
        own engine); the dispatcher folds it into the ready index."""
        with self._mu:
            group = self._by_lane.get(name)
        if group is None:
            return False
        host = group.host
        host_lane = group.host_lane
        for req in list(getattr(host, "queue", ())):
            if req is not None and (getattr(req, "model", "") or host_lane) == name:
                return True
        for req in list(getattr(host, "slots", ())):
            if req is not None and (getattr(req, "model", "") or host_lane) == name:
                return True
        return False

    def begin_retire(self, name: str) -> None:
        """Start retiring ``name``: if it hosts a multi-lane group, mark
        the group disbanding — ``step_group`` then refills only from the
        retiring lane, so the host drains while survivors' queued work
        waits (bounded by in-flight ``max_new_tokens``).  No-op for
        non-host members and solo lanes."""
        with self._mu:
            group = self._by_lane.get(name)
            if group is not None and group.host_lane == name and len(group.lanes) > 1:
                group.retiring = name

    def finish_retire(self, name: str) -> None:
        """Remove ``name`` from its group after its drain completed.  A
        departing host (engine now idle — the unregister drain ran it dry)
        dissolves the group and re-forms the survivors around a new host
        (the next member in join order); a departing member just leaves.
        """
        with self._mu:
            group = self._by_lane.pop(name, None)
            self._engines.pop(name, None)
            if group is None:
                return
            if name in group.lanes:
                group.lanes.remove(name)
            group.retiring = None
            if group.host_lane != name:
                return
            self._groups.pop(group.key, None)
            survivors = list(group.lanes)
            for s in survivors:
                self._by_lane.pop(s, None)
            for s in survivors:
                engine = self._engines.get(s)
                if engine is not None:
                    self._add_locked(s, engine, group.key)

    def snapshot(self) -> dict:
        """Membership summary for dispatcher snapshots: group count and,
        per host lane, the member list and current per-lane occupancy."""
        with self._mu:
            groups = list(self._groups.values())
        return {
            "groups": len(groups),
            "by_host": {
                g.host_lane: {
                    "lanes": list(g.lanes),
                    "occupancy": g.occupancy(),
                }
                for g in groups
            },
        }
