"""Span tracer exporting Chrome trace-event JSON (Perfetto-loadable); the
port's own copy of ``repro/obs/trace.py``, which is framework-free.

Design points:

* **Near-zero cost when disabled.** The engine holds ``NULL_TRACER`` by
  default; every call site guards with ``if tracer.enabled`` (one
  attribute load) so the disabled path does no formatting, no clock
  reads, no allocation.
* **Flight recorder.** Events live in a bounded ``deque(maxlen=ring)``
  — the newest ``ring`` events double as the crash ring buffer. The
  engine calls :meth:`Tracer.flight_dump` from its exception path so a
  stuck or crashing run leaves a postmortem trace on disk.
* **Two clocks.** Callers either pass explicit timestamps in *anchored
  seconds* (the serving engine passes its own engine-relative clock
  after ``anchor(0.0)``) or use the :meth:`span` context manager, which
  reads ``perf_counter`` and lazily anchors at the first event (the
  federated server path).

Track convention (pid/tid): pid 1 = the engine loop (tid 0), pid 2 =
one thread per request rid, pid 3 = federated rounds. Metadata events
(``ph: "M"``) name the tracks; they are kept out of the ring so names
survive arbitrarily long runs.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

PID_ENGINE = 1
PID_REQUESTS = 2
PID_FEDERATED = 3


class Tracer:
    enabled = True

    def __init__(self, ring: int = 65536,
                 flight_path: Optional[str] = None) -> None:
        self.events: deque = deque(maxlen=int(ring))
        self.dropped = 0          # events pushed out of the ring
        self.flight_path = flight_path
        self._meta: Dict[Tuple[int, Optional[int]], dict] = {}
        self._t0: Optional[float] = None   # perf_counter at anchored 0

    # -- clock ------------------------------------------------------------
    def anchor(self, now_s: float = 0.0) -> None:
        """Declare that ``perf_counter()`` *right now* corresponds to
        anchored time ``now_s``. The engine anchors 0.0 at run start and
        then passes its own relative timestamps."""
        self._t0 = time.perf_counter() - now_s

    def now(self) -> float:
        if self._t0 is None:
            self.anchor(0.0)
        return time.perf_counter() - self._t0

    # -- event emission (timestamps in anchored seconds) ------------------
    def _push(self, ev: dict) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def complete(self, name: str, start_s: float, end_s: float, *,
                 pid: int = PID_ENGINE, tid: int = 0, cat: str = "",
                 args: Optional[dict] = None) -> None:
        """A ``ph: "X"`` complete event spanning [start_s, end_s]."""
        ev = {"name": name, "ph": "X", "ts": start_s * 1e6,
              "dur": max(0.0, (end_s - start_s) * 1e6),
              "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, t_s: float, *, pid: int = PID_ENGINE,
                tid: int = 0, cat: str = "",
                args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "i", "ts": t_s * 1e6, "s": "t",
              "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, t_s: float, values: Dict[str, float], *,
                pid: int = PID_ENGINE, tid: int = 0) -> None:
        """A ``ph: "C"`` counter sample — renders as a track in Perfetto
        (queue depth, free blocks, active slots over time)."""
        self._push({"name": name, "ph": "C", "ts": t_s * 1e6,
                    "pid": pid, "tid": tid,
                    "args": {k: float(v) for k, v in values.items()}})

    @contextmanager
    def span(self, name: str, *, pid: int = PID_ENGINE, tid: int = 0,
             cat: str = "", args: Optional[dict] = None) -> Iterator[None]:
        """Wall-clock span using the tracer's own (lazily anchored)
        clock — the federated-server idiom."""
        t0 = self.now()
        try:
            yield
        finally:
            self.complete(name, t0, self.now(), pid=pid, tid=tid, cat=cat,
                          args=args)

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
        events = list(self._meta.values()) + sorted(
            self.events, key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

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

    @contextmanager
    def span(self, *a, **kw) -> Iterator[None]:
        yield

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
