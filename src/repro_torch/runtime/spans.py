"""Spans and counters inside the port, off unless a caller records.

``span(name, **attrs)`` marks a stretch of host work (``with
span("fd.round", round=i): ...``) and ``count(name, n)`` adds to a
named counter.  While no recording is open, each costs one check of a
module global: ``span`` returns the one shared :data:`NOOP`, whose
``with`` does nothing (no span object, no clock read, no
``record_function``), and ``count`` returns.

``recording(annotate=False)`` turns both on for its body and yields the
:class:`Record`:

* ``spans``: one :class:`Span` a ``span`` opened, in the order they
  opened: its name and attributes, its start and end, its parent (the
  index in ``spans`` of the innermost span open on its thread), its
  thread's native id, and ``call``, the id of the root span it belongs
  to (one ``run_many`` call, one training step);
* ``counters``: what ``count`` added, by name;
* ``launches``: the change of each kernel's count in
  ``kernels/_build.LAUNCHES`` over the body, read from that counter (it
  stays the one launch counter).

A thread with no span of its own open while a root span is open (the
autograd engine's thread on the card, which runs the backward and
remat's replay of the forward while the step's thread waits in
``torch.autograd.grad``) takes as parent the innermost span open on the
root's thread, and the root's call.  :func:`self_ns` gives each span's
self time: its duration less the time its children cover.

**Clock.**  ``torch.profiler`` stamps its events, the host's operators
and (through CUPTI's timestamp callback) the card's kernels, on the Unix
clock (``time.time_ns()``, CLOCK_REALTIME), not on ``perf_counter_ns``'s
CLOCK_MONOTONIC; so spans are stamped with ``time.time_ns()``, and a
span's interval and a profiler event's ``start_ns()`` compare as they
are.  A step of the system clock inside a recording shifts the spans
after it.  With ``annotate=True`` each span also opens
``torch.autograd.profiler.record_function(name)``, which puts it on the
profiler's timeline.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional

from repro_torch.kernels import _build

_REC: Optional["Record"] = None


class _Noop:
    """The span handed out while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: what :func:`span` returns while no recording is open
NOOP = _Noop()


@dataclasses.dataclass
class Span:
    name: str
    attrs: dict
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    thread: int
    call: int

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns


class Record:
    """What one :func:`recording` saw (see the module's docstring)."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._launch0 = dict(_build.LAUNCHES)
        self._launches: Optional[Dict[str, int]] = None
        self._local = threading.local()
        self._lock = threading.Lock()
        self._root: Optional[list] = None   # the root thread's stack
        self._calls = 0

    @property
    def launches(self) -> Dict[str, int]:
        """Launches of each kernel since the recording opened (until it
        closed)."""
        if self._launches is not None:
            return self._launches
        return {k: n - self._launch0.get(k, 0)
                for k, n in _build.LAUNCHES.items()}

    def _mine(self) -> tuple:
        """This thread's stack of open spans and its native id (read
        once a thread: it is a system call, several microseconds on some
        hosts)."""
        loc = self._local
        try:
            return loc.stack, loc.tid
        except AttributeError:
            loc.stack, loc.tid = [], threading.get_native_id()
            return loc.stack, loc.tid

    def _close(self) -> None:
        self._launches = self.launches


class _Open:
    """An open span of a recording."""
    __slots__ = ("rec", "name", "attrs", "index", "stack", "rf")

    def __init__(self, rec: Record, name: str, attrs: dict):
        self.rec, self.name, self.attrs, self.rf = rec, name, attrs, None

    def __enter__(self):
        rec = self.rec
        stack, tid = rec._mine()
        self.stack = stack
        with rec._lock:
            root = rec._root
            if stack:
                parent = stack[-1]
            elif root:
                parent = root[-1]
            else:
                parent = None
                rec._calls += 1
                rec._root = stack
            call = rec.spans[parent].call if parent is not None \
                else rec._calls
            self.index = len(rec.spans)
            rec.spans.append(Span(self.name, self.attrs, 0, None, parent,
                                  tid, call))
        stack.append(self.index)
        if rec.annotate:
            from torch.autograd.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.rec.spans[self.index].start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rec.spans[self.index].end_ns = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        return False


def span(name: str, **attrs):
    """A context manager over a stretch of host work named ``name``."""
    if _REC is None:
        return NOOP
    return _Open(_REC, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open recording."""
    if _REC is not None:
        with _REC._lock:
            _REC.counters[name] = _REC.counters.get(name, 0) + n


@contextlib.contextmanager
def recording(annotate: bool = False) -> Iterator[Record]:
    """Spans and counters on for the body; yields its :class:`Record`.
    Recordings do not nest."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is already open")
    rec = _REC = Record(annotate)
    try:
        yield rec
    finally:
        _REC = None
        rec._close()


def self_ns(rec: Record) -> List[int]:
    """Each span's self time (ns): its duration less the union of its
    children's intervals within it (children on another thread
    included: its thread waits for them)."""
    kids: Dict[int, list] = {}
    for i, s in enumerate(rec.spans):
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(i)
    out = []
    for i, s in enumerate(rec.spans):
        covered, end = 0, s.start_ns
        for c in sorted((rec.spans[j] for j in kids.get(i, ())),
                        key=lambda c: c.start_ns):
            a, b = max(c.start_ns, end), min(c.end_ns, s.end_ns)
            if b > a:
                covered += b - a
            end = max(end, min(c.end_ns, s.end_ns))
        out.append(s.dur_ns - covered)
    return out
