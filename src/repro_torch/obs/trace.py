"""Span tracer exporting Chrome trace-event JSON (Perfetto-loadable); the
port's copy of ``repro/obs/trace.py``, extended with the port's own layer
spans, device markers and host-sync counts.

Design points:

* **Near-zero cost when disabled.** ``NULL_TRACER`` is the default; every
  call site guards with ``if tracer.enabled`` (one attribute load), and
  ``NULL_TRACER.span`` hands back one shared no-op context, so the
  disabled path does no formatting, no clock reads, no allocation.
* **Flight recorder.** Events live in a bounded ``deque(maxlen=ring)``
  — the newest ``ring`` events double as the crash ring buffer. The
  engine calls :meth:`Tracer.flight_dump` from its exception path so a
  stuck or crashing run leaves a postmortem trace on disk.
* **One clock with the device trace.** The tracer stamps with
  ``time.time_ns()``, the clock ``torch.profiler`` (kineto) stamps its
  events with: a span's start and end in ns compare directly with a
  profiler event's ``start_ns``.  Its time 0 (``epoch_ns``) is the
  first :meth:`Tracer.anchor`.  Callers either pass explicit times in
  *anchored seconds* (the serving engine passes its engine-relative
  clock after ``anchor(0.0)``; each later anchor re-bases those times,
  not the epoch) or use :meth:`Tracer.span`, which reads the clock
  itself.  ``events`` hold µs from the epoch; :meth:`to_dict` and
  :meth:`dump` write absolute µs since the Unix epoch (the epoch in
  ``otherData``), so the file lines up with
  ``prof.export_chrome_trace()``'s events.  A tracer never anchored
  and fed explicit times only writes them as given, as the reference.
* **Spans with parents.** :meth:`Tracer.span` keeps the open-span stack
  itself: a span opened inside another gets its parent's id, its
  track (pid, tid) and its ids (``rid``/``rids`` of a request,
  ``round``, ``client``/``clients``) unless it names its own.  Span
  events carry ``span_id``/``parent_id`` and the ids beside ``args``.
  The port's own layer spans (``engine.iter``, ``model.*``, ``pool.*``,
  ``client.*``, ``agg.*``, ...) have ``cat: "layer"``; the reference's
  spans keep their categories.

The process-wide session: engines and servers built with ``tracer=None``
resolve their tracer at each run or round through :func:`active`: an
explicit tracer (passed, or installed with :func:`use`), else, while a
``torch.profiler`` session is recording in the process, a session tracer,
else ``NULL_TRACER``.  So a ``torch.profiler`` window gets the program's
spans on its own timeline with no setting.  While the session is open
(CUDA processes):

* spans made with ``device=True`` (the ones that enqueue device work:
  ``distribute``, ``agg.*``, ``aggregate``, ``model.*``, ``client.step``)
  record a CUDA event pair, resolved once when the session is read into
  ``dev_ms``: the device time from the start marker to the end marker,
  with no sync inside the window;
* ``torch.cuda.set_sync_debug_mode("warn")`` flags every host↔device
  synchronisation (``.item()``, ``.cpu()``, ``nonzero``, blocking
  host-to-device copies); each is counted with its time, the innermost
  open span and the source line that made it (the innermost frame
  outside torch and this module), and not printed.  The prior mode,
  ``warnings.showwarning`` and the warning filters are restored when the
  session closes.

:func:`last_session` closes the session and returns what it recorded
(spans, syncs, counters); the record stays readable until the next
session opens.  Lower layers (model, pool, client, optimizer) read the
run's or round's tracer with :func:`current`.

Track convention (pid/tid): pid 1 = the engine loop (tid 0), pid 2 =
one thread per request rid, pid 3 = federated rounds (tid 0; the device
round driver's segment work on tid 1). Metadata events (``ph: "M"``)
name the tracks; they are kept out of the ring so names survive
arbitrarily long runs.
"""
from __future__ import annotations

import functools
import json
import os
import sys
import time
import warnings
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

PID_ENGINE = 1
PID_REQUESTS = 2
PID_FEDERATED = 3
LAYER = "layer"
SYNC_MESSAGE = "called a synchronizing CUDA operation"


class _Span:
    """An open span: the context :meth:`Tracer.span` returns.  ``note``
    adds ``args`` before it closes; ``drop`` discards it."""

    __slots__ = ("tracer", "name", "pid", "tid", "cat", "args", "ids",
                 "device", "id", "parent", "t0", "marks", "keep")

    def __init__(self, tracer, name, pid, tid, cat, args, ids, device):
        self.tracer, self.name, self.cat = tracer, name, cat
        self.pid, self.tid, self.args, self.ids = pid, tid, args, ids
        self.device, self.marks, self.keep = device, None, True

    def note(self, **args) -> None:
        self.args = {**(self.args or {}), **args}

    def drop(self) -> None:
        self.keep = False

    def __enter__(self) -> "_Span":
        self.tracer._open(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.tracer._close(self)
        return False


class _NullSpan:
    __slots__ = ()

    def note(self, **args) -> None:
        pass

    def drop(self) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    enabled = True

    def __init__(self, ring: int = 65536,
                 flight_path: Optional[str] = None) -> None:
        self.events: deque = deque(maxlen=int(ring))
        self.dropped = 0          # events pushed out of the ring
        self.flight_path = flight_path
        self.totals: Dict[str, float] = {}   # counters added with add()
        self._meta: Dict[Tuple[int, Optional[int]], dict] = {}
        self._epoch_ns: Optional[int] = None  # time.time_ns() at time 0
        self._off_ns = 0          # anchored seconds + offset = tracer time
        self._stack: List[_Span] = []
        self._next_id = 1
        # (span id, start event, end event) while a session records device
        # markers; None otherwise
        self._marks: Optional[List[Tuple[int, Any, Any]]] = None

    # -- clock ------------------------------------------------------------
    def anchor(self, now_s: float = 0.0) -> None:
        """Declare that ``time.time_ns()`` *right now* corresponds to
        anchored time ``now_s``. The engine anchors 0.0 at run start and
        then passes its own relative timestamps.  The first anchor fixes
        the tracer's epoch; a later one re-bases explicit times only."""
        t = time.time_ns()
        if self._epoch_ns is None:
            self._epoch_ns = t - round(now_s * 1e9)
        self._off_ns = t - self._epoch_ns - round(now_s * 1e9)

    def now(self) -> float:
        if self._epoch_ns is None:
            self.anchor(0.0)
        return (time.time_ns() - self._epoch_ns - self._off_ns) * 1e-9

    @property
    def epoch_ns(self) -> Optional[int]:
        return self._epoch_ns

    # -- event emission (timestamps in anchored seconds) ------------------
    def _push(self, ev: dict) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def complete(self, name: str, start_s: float, end_s: float, *,
                 pid: int = PID_ENGINE, tid: int = 0, cat: str = "",
                 args: Optional[dict] = None, **ids) -> None:
        """A ``ph: "X"`` complete event spanning [start_s, end_s]; ``ids``
        as :meth:`span`'s."""
        ev = {"name": name, "ph": "X",
              "ts": start_s * 1e6 + self._off_ns / 1e3,
              "dur": max(0.0, (end_s - start_s) * 1e6),
              "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        ev.update(ids)
        self._push(ev)

    def instant(self, name: str, t_s: float, *, pid: int = PID_ENGINE,
                tid: int = 0, cat: str = "",
                args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "i", "ts": t_s * 1e6 + self._off_ns / 1e3,
              "s": "t", "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, t_s: float, values: Dict[str, float], *,
                pid: int = PID_ENGINE, tid: int = 0) -> None:
        """A ``ph: "C"`` counter sample — renders as a track in Perfetto
        (queue depth, free blocks, active slots over time)."""
        self._push({"name": name, "ph": "C",
                    "ts": t_s * 1e6 + self._off_ns / 1e3,
                    "pid": pid, "tid": tid,
                    "args": {k: float(v) for k, v in values.items()}})

    def add(self, name: str, value: float) -> None:
        """Add ``value`` to the running counter ``name`` (``totals``)."""
        self.totals[name] = self.totals.get(name, 0) + value

    def span(self, name: str, *, pid: Optional[int] = None,
             tid: Optional[int] = None, cat: str = LAYER,
             args: Optional[dict] = None, device: bool = False,
             **ids) -> _Span:
        """A span on the tracer's clock, as a context manager: nested
        spans get its id as their parent, its track and its ``ids``
        (``rid``, ``rids``, ``round``, ``client``, ``clients``).  A span
        with no open parent and no ``pid`` goes on the engine track.
        ``device``: record device markers while a session is open."""
        return _Span(self, name, pid, tid, cat, args, ids, device)

    def _open(self, sp: _Span) -> None:
        if self._epoch_ns is None:
            self.anchor(0.0)
        up = self._stack[-1] if self._stack else None
        sp.id, self._next_id = self._next_id, self._next_id + 1
        sp.parent = up.id if up is not None else None
        if sp.pid is None:
            sp.pid = up.pid if up is not None else PID_ENGINE
            if sp.tid is None and up is not None:
                sp.tid = up.tid
        if sp.tid is None:
            sp.tid = 0
        if up is not None and up.ids:
            sp.ids = {**up.ids, **sp.ids}
        self._stack.append(sp)
        if sp.device and self._marks is not None:
            sp.marks = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            sp.marks[0].record()
        sp.t0 = time.time_ns()

    def _close(self, sp: _Span) -> None:
        t1 = time.time_ns()
        if sp.marks is not None:
            sp.marks[1].record()
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        elif sp in self._stack:
            self._stack.remove(sp)
        if not sp.keep:
            return
        ev = {"name": sp.name, "ph": "X", "ts": (sp.t0 - self._epoch_ns) / 1e3,
              "dur": (t1 - sp.t0) / 1e3, "pid": sp.pid, "tid": sp.tid,
              "span_id": sp.id}
        if sp.parent is not None:
            ev["parent_id"] = sp.parent
        if sp.cat:
            ev["cat"] = sp.cat
        if sp.args:
            ev["args"] = sp.args
        ev.update(sp.ids)
        self._push(ev)
        if sp.marks is not None and self._marks is not None:
            self._marks.append((sp.id,) + sp.marks)

    # -- track naming -----------------------------------------------------
    def process_name(self, pid: int, name: str) -> None:
        self._meta[(pid, None)] = {
            "name": "process_name", "ph": "M", "ts": 0, "pid": pid,
            "tid": 0, "args": {"name": name}}

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        self._meta[(pid, tid)] = {
            "name": "thread_name", "ph": "M", "ts": 0, "pid": pid,
            "tid": tid, "args": {"name": name}}

    # -- export -----------------------------------------------------------
    def to_dict(self) -> dict:
        """Chrome trace-event JSON: absolute µs since the Unix epoch once
        the tracer is anchored (start and end each rounded once, so spans
        still nest), the times as given otherwise."""
        timed = sorted(self.events, key=lambda e: e["ts"])
        other = {"dropped_events": self.dropped}
        if self._epoch_ns is not None:
            timed = [_absolute(e, self._epoch_ns) for e in timed]
            other.update(epoch_ns=self._epoch_ns, clock="time.time_ns")
        return {"traceEvents": list(self._meta.values()) + timed,
                "displayTimeUnit": "ms", "otherData": other}

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, allow_nan=False)
        return path

    def flight_dump(self) -> Optional[str]:
        """Write the ring buffer to ``flight_path`` (postmortem). Returns
        the path written, or None when no flight path is configured."""
        if not self.flight_path:
            return None
        return self.dump(self.flight_path)


def _absolute(ev: dict, epoch_ns: int) -> dict:
    out = dict(ev)
    start = epoch_ns + round(ev["ts"] * 1e3)
    out["ts"] = start / 1e3
    if "dur" in ev:
        out["dur"] = (start + round(ev["dur"] * 1e3)) / 1e3 - out["ts"]
    return out


class _NullTracer:
    """Disabled tracer: every method is a no-op. Hot paths additionally
    guard on ``enabled`` so arguments are never even built."""

    enabled = False
    events: deque = deque(maxlen=0)
    dropped = 0
    flight_path = None

    def anchor(self, now_s: float = 0.0) -> None:
        pass

    def now(self) -> float:
        return 0.0

    def complete(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def counter(self, *a, **kw) -> None:
        pass

    def add(self, *a, **kw) -> None:
        pass

    def span(self, *a, **kw) -> _NullSpan:
        return _NULL_SPAN

    def process_name(self, *a, **kw) -> None:
        pass

    def thread_name(self, *a, **kw) -> None:
        pass

    def to_dict(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        raise RuntimeError("cannot dump the null tracer")

    def flight_dump(self) -> Optional[str]:
        return None


NULL_TRACER = _NullTracer()


# ==========================================================================
# the process-wide session
# ==========================================================================

_INSTALLED: List[Any] = []      # tracers installed with use(), innermost last
_SESSION: Optional["_Session"] = None
_LAST: Dict[str, Any] = {}
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SKIP = (os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,
         os.path.abspath(warnings.__file__), os.path.abspath(__file__))


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording in the process."""
    return torch._C._autograd._profiler_enabled()


def _get_sync_mode() -> Optional[int]:
    return (torch.cuda.get_sync_debug_mode() if torch.cuda.is_available()
            else None)


def _set_sync_mode(mode) -> None:
    torch.cuda.set_sync_debug_mode(mode)


def _site(filename: str, lineno: int) -> str:
    """The innermost calling line outside torch, ``warnings`` and this
    module, as ``package/path.py:line``."""
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if not fn.startswith(_SKIP[0]) and fn not in _SKIP[1:]:
            filename, lineno = fn, f.f_lineno
            break
        f = f.f_back
    fn = os.path.abspath(filename)
    rel = (os.path.relpath(fn, _SRC) if fn.startswith(_SRC + os.sep)
           else os.path.join(os.path.basename(os.path.dirname(fn)),
                             os.path.basename(fn)))
    return f"{rel}:{lineno}"


class _Session:
    """What a ``torch.profiler`` session records of the program: its
    tracer (with device markers on a CUDA process) and the host syncs."""

    def __init__(self) -> None:
        self.tracer = Tracer()
        self.syncs: List[Tuple[int, Optional[int], Optional[str], str]] = []
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            self.tracer._marks = []
        self._prev_mode = _get_sync_mode()
        self._prev_show = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_MESSAGE,
                                category=UserWarning)
        self._filter = warnings.filters[0]
        warnings.showwarning = self._on_warning
        if self._prev_mode is not None:
            _set_sync_mode("warn")
        self.open = True

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if not str(message).startswith(SYNC_MESSAGE):
            return self._prev_show(message, category, filename, lineno,
                                   file, line)
        if not self.open:
            return None
        if not _profiling():
            self.stop()
            return None
        stack = self.tracer._stack
        top = stack[-1] if stack else None
        self.syncs.append((time.time_ns(), top.id if top else None,
                           top.name if top else None,
                           _site(filename, lineno)))
        return None

    def stop(self) -> None:
        """Stop counting and restore what the session changed."""
        if not self.open:
            return
        self.open = False
        if self._prev_mode is not None:
            _set_sync_mode(self._prev_mode)
        if warnings.showwarning == self._on_warning:
            warnings.showwarning = self._prev_show
        if self._filter in warnings.filters:
            warnings.filters.remove(self._filter)
            mutated = getattr(warnings, "_filters_mutated", None)
            if mutated is not None:
                mutated()

    def record(self) -> Dict[str, Any]:
        """Stop, resolve the device markers and return the record."""
        self.stop()
        tr = self.tracer
        dev_ms: Dict[int, float] = {}
        if tr._marks:
            torch.cuda.synchronize()
            dev_ms = {sid: a.elapsed_time(b) for sid, a, b in tr._marks}
        tr._marks = None
        spans = []
        for ev in tr.events:
            if ev["ph"] != "X":
                continue
            start = tr.epoch_ns + round(ev["ts"] * 1e3)
            sp = {k: v for k, v in ev.items()
                  if k not in ("ph", "ts", "dur", "span_id", "parent_id")}
            sp.update(id=ev.get("span_id"), parent=ev.get("parent_id"),
                      start_ns=start, end_ns=start + round(ev["dur"] * 1e3))
            if sp["id"] in dev_ms:
                sp["dev_ms"] = dev_ms[sp["id"]]
            spans.append(sp)
        return {"spans": spans,
                "syncs": [{"t_ns": t, "span": sid, "span_name": name,
                           "site": site}
                          for t, sid, name, site in self.syncs],
                "counters": dict(tr.totals), "epoch_ns": tr.epoch_ns,
                "dropped_events": tr.dropped, "device_markers": self.cuda}


def current():
    """The tracer of the run or round in progress (:func:`use`), else
    ``NULL_TRACER``: what the model, pool, client and optimizer record
    into."""
    return _INSTALLED[-1] if _INSTALLED else NULL_TRACER


@contextmanager
def use(tracer) -> Iterator[Any]:
    """Install ``tracer`` for the duration: :func:`active` and
    :func:`current` return it."""
    _INSTALLED.append(tracer)
    try:
        yield tracer
    finally:
        _INSTALLED.remove(tracer)


def active(tracer=None):
    """The tracer a run or round records into: ``tracer`` when given,
    else an installed one, else the session tracer while a
    ``torch.profiler`` session records (opening the session), else
    ``NULL_TRACER`` (closing a session whose profiler has stopped)."""
    global _SESSION, _LAST
    if tracer is not None:
        return tracer
    if _INSTALLED:
        return _INSTALLED[-1]
    if _profiling():
        if _SESSION is not None and not _SESSION.open:
            last_session()           # its profiler stopped in between
        if _SESSION is None:
            _SESSION, _LAST = _Session(), {}
        return _SESSION.tracer
    if _SESSION is not None:
        last_session()
    return NULL_TRACER


def last_session() -> Dict[str, Any]:
    """Close the open session, if any, and return the newest session's
    record: ``spans`` (every complete event: ``name``, ``id`` and
    ``parent`` (None for one given explicit times), ``start_ns``,
    ``end_ns`` on ``time.time_ns``'s clock, ``pid``, ``tid``, ``cat``,
    ``args`` and ids where set, ``dev_ms`` for a device span on a CUDA
    process), ``syncs`` (``t_ns``, ``span`` id, ``span_name``, ``site``),
    ``counters``.  Empty when no session was opened."""
    global _SESSION, _LAST
    if _SESSION is not None:
        _LAST, _SESSION = _SESSION.record(), None
    return _LAST


def traced(name: str, device: bool = False) -> Callable:
    """Decorator: the function's call is a span ``name`` of the current
    tracer (one check when there is none)."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            tr = current()
            if not tr.enabled:
                return fn(*args, **kwargs)
            with tr.span(name, device=device):
                return fn(*args, **kwargs)
        return call
    return wrap


_REQUIRED = {"name", "ph", "ts", "pid", "tid"}


def validate_chrome_trace(trace: dict) -> List[str]:
    """Structural check of a Chrome trace-event dict: required fields on
    every event, numeric non-negative ts/dur, and — per (pid, tid) track
    — ``X`` spans that nest properly (no partial overlap). Returns a
    list of problems; empty means valid."""
    errors: List[str] = []
    if "traceEvents" not in trace or not isinstance(trace["traceEvents"],
                                                   list):
        return ["missing traceEvents list"]
    spans: Dict[Tuple[int, int], List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(trace["traceEvents"]):
        missing = _REQUIRED - set(ev)
        if missing:
            errors.append(f"event {i}: missing {sorted(missing)}")
            continue
        if ev["ph"] == "M":
            continue
        ts = ev["ts"]
        if not (isinstance(ts, (int, float)) and ts >= 0):
            errors.append(f"event {i} ({ev['name']}): bad ts {ts!r}")
            continue
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not (isinstance(dur, (int, float)) and dur >= 0):
                errors.append(f"event {i} ({ev['name']}): bad dur {dur!r}")
                continue
            spans.setdefault((ev["pid"], ev["tid"]), []).append(
                (ts, ts + dur, ev["name"]))
    eps = 1e-3  # µs slop for float rounding
    for track, ss in spans.items():
        ss.sort(key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[float, float, str]] = []
        for s in ss:
            while stack and stack[-1][1] <= s[0] + eps:
                stack.pop()
            if stack and s[1] > stack[-1][1] + eps:
                errors.append(
                    f"track {track}: span {s[2]!r} [{s[0]:.1f},{s[1]:.1f}] "
                    f"partially overlaps {stack[-1][2]!r} "
                    f"[{stack[-1][0]:.1f},{stack[-1][1]:.1f}]")
            stack.append(s)
    return errors
