"""Named crash-injection seams for deterministic infrastructure chaos.

The port's copy of the reference's ``repro/core/faultpoints.py``, with the
same point names, so a kill schedule drives either package's writers.

The robustness guarantees of the port (crash-safe spool recovery, the
verdict index's journal and snapshot) are only as good as the tests that
kill the writers at *exactly* the boundary under scrutiny.  Timing-based kills
(SIGKILL after a sleep) are nondeterministic and cannot hit a specific
``os.replace``; instead the writers call :func:`fault_point` at every
write/rename boundary and the chaos harness *arms* a point by name:

    with faultpoints.armed("spool.segment.written"):
        try:
            produce_spool(...)          # crashes mid-flush
        except faultpoints.InjectedCrash:
            pass
    report = TraceSpool.recover(d)      # must salvage, never tear

An unarmed point is a dict miss — zero cost on the clean path, which is
what keeps the byte-identity gates (``VERDICTS_synthetic.json``, spool
finalize) honest.  Arming is process-global and test-scoped; the context
manager restores the previous arming on exit.

Crash fidelity: the spool writer and the verdict index keep no cleanup
handlers between appends, so an in-process :class:`InjectedCrash` leaves
*exactly* the disk state a SIGKILL would (torn tmp files and all).
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional

__all__ = ["InjectedCrash", "fault_point", "armed", "arm", "disarm_all",
           "hits"]


class InjectedCrash(RuntimeError):
    """Raised by an armed fault point; carries the point name."""

    def __init__(self, name: str):
        super().__init__(f"injected crash at fault point {name!r}")
        self.point = name


@dataclasses.dataclass
class _Arm:
    nth: int                      # trigger on the nth hit (1-based)
    action: Callable[[str], None]
    hits: int = 0


_ARMED: Dict[str, _Arm] = {}
_COUNTERS: list = []            # active hit-counter dicts (nested scopes)


def fault_point(name: str) -> None:
    """Seam marker: no-op unless ``name`` is armed (or counting is on)."""
    for counter in _COUNTERS:
        counter[name] = counter.get(name, 0) + 1
    a = _ARMED.get(name)
    if a is None:
        return
    a.hits += 1
    if a.hits == a.nth:
        a.action(name)


def _raise_crash(name: str) -> None:
    raise InjectedCrash(name)


def arm(name: str, nth: int = 1,
        action: Optional[Callable[[str], None]] = None) -> None:
    """Arm ``name`` to fire on its ``nth`` hit (default action: raise
    :class:`InjectedCrash`)."""
    if nth < 1:
        raise ValueError(f"nth must be >= 1, got {nth}")
    _ARMED[name] = _Arm(nth=nth, action=action or _raise_crash)


def disarm_all() -> None:
    _ARMED.clear()


@contextmanager
def armed(name: str, nth: int = 1,
          action: Optional[Callable[[str], None]] = None) -> Iterator[None]:
    """Scoped arming; restores the previous arming of ``name`` on exit."""
    prev = _ARMED.get(name)
    arm(name, nth=nth, action=action)
    try:
        yield
    finally:
        if prev is None:
            _ARMED.pop(name, None)
        else:
            _ARMED[name] = prev


@contextmanager
def hits() -> Iterator[Dict[str, int]]:
    """Count every fault-point hit in the block (used by the kill-schedule
    sweep to discover how many times each boundary fires)."""
    counter: Dict[str, int] = {}
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)
