"""The traced run: ``torch.profiler`` over the window, the benchmark's own
spans around the program's calls, and the kernel calls the roofline
counts read.

Spans (host-clock intervals, the clock kineto stamps its events with) are
put round the program's entry points by wrapping them for the traced
window only, from this file: the program itself is not changed.  The
profiler records device activity only, so the host runs at its untraced
pace.  Kernel calls are recorded
by wrapping the dispatch functions of ``repro_torch.kernels.backend``:
shapes as host integers, and for the expert products a reference to the
routing counts of the same layer (the router's own output), reduced once
after the window.  Nothing here adds a device operation to the window.

The profiler's events are read in memory (``kineto_results.events()``):
device busy time is the union of every device activity's interval, time
by kernel name is summed, and each stretch where the device idled is
charged to the innermost span the host was in when it began.
"""
from __future__ import annotations

import contextlib
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import window as win

Patch = Tuple[object, str, Callable]


def _span(label: str, fn: Callable, out: List) -> Callable:
    def wrapped(*args, **kwargs):
        t0 = time.time_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            out.append((t0, time.time_ns(), label))
    wrapped.__wrapped__ = fn
    return wrapped


@contextlib.contextmanager
def patched(patches: List[Patch]):
    """Swap ``obj.name`` for ``make(original)`` for the duration."""
    saved = []
    try:
        for obj, name, make in patches:
            orig = getattr(obj, name)
            saved.append((obj, name, orig))
            setattr(obj, name, make(orig))
        yield
    finally:
        for obj, name, orig in reversed(saved):
            setattr(obj, name, orig)


def span_patches(spans: Dict[str, Tuple[object, str]],
                 out: List) -> List[Patch]:
    """A span round each ``(obj, name)`` the program still has."""
    return [(obj, name, (lambda f, lab=label: _span(lab, f, out)))
            for label, (obj, name) in spans.items() if hasattr(obj, name)]


class CallRecorder:
    """Records the calls of the kernel dispatch functions."""

    def __init__(self):
        self.calls: Dict[str, List[Dict]] = {}
        self._route = None           # (counts tensor, capacity or None)

    def _add(self, entry: str, **kw) -> None:
        self.calls.setdefault(entry, []).append(kw)

    def patches(self) -> List[Patch]:
        from repro_torch.kernels import backend as kb

        def router(fn):
            def w(logits, k):
                out = fn(logits, k)
                self._route = (out[2], int(logits.shape[0]) * int(k))
                return out
            return w

        def adaptive(fn):
            def w(logits, k_tok, max_k):
                out = fn(logits, k_tok, max_k)
                self._route = (out[2], None)
                return out
            return w

        def lora(fn):
            def w(x, wt, a, b, *, scale):
                self._add("lora_matmul", rows=int(x.shape[0]),
                          K=int(wt.shape[0]), N=int(wt.shape[1]),
                          r=int(a.shape[1]), elem=x.element_size(),
                          dtype=x.dtype)
                return fn(x, wt, a, b, scale=scale)
            return w

        def experts(fn):
            def w(x, wt, a, b, *, scale):
                counts, n_assign = self._route
                self._add("lora_matmul_experts", counts=counts,
                          C=int(x.shape[1]), K=int(wt.shape[1]),
                          N=int(wt.shape[2]), r=int(a.shape[2]),
                          elem=x.element_size(), dtype=x.dtype)
                return fn(x, wt, a, b, scale=scale)
            return w

        def ragged(fn):
            def w(xs, block_expert, wt, a=None, b=None, *, scale=0.0):
                self._add("ragged_expert_matmul", counts=self._route[0],
                          K=int(wt.shape[1]), N=int(wt.shape[2]),
                          r=0 if a is None else int(a.shape[2]),
                          elem=xs.element_size(), dtype=xs.dtype)
                return fn(xs, block_expert, wt, a, b, scale=scale)
            return w

        def flash(fn):
            def w(q, k, v, **kw):
                B, S, H, D = (int(s) for s in q.shape)
                self._add("flash_attention", B=B, S=S, H=H,
                          KV=int(k.shape[2]), D=D, elem=q.element_size(),
                          dtype=q.dtype)
                return fn(q, k, v, **kw)
            return w

        return [(kb, "router", router), (kb, "adaptive_router", adaptive),
                (kb, "lora_matmul", lora),
                (kb, "lora_matmul_experts", experts),
                (kb, "ragged_expert_matmul", ragged),
                (kb, "flash_attention", flash)]

    def resolve(self) -> Dict[str, List[Dict]]:
        """Turn the recorded routing counts into rows and experts used
        (one device read for all calls)."""
        out = {}
        for entry, calls in self.calls.items():
            routed = [c for c in calls if "counts" in c]
            if routed:
                counts = torch.stack([c["counts"].float() for c in routed])
                caps = torch.tensor([c.get("C", 1 << 30) for c in routed],
                                    dtype=torch.float32,
                                    device=counts.device)[:, None]
                rows = torch.minimum(counts, caps).sum(1).cpu().tolist()
                used = (counts > 0).sum(1).cpu().tolist()
                for c, n, e in zip(routed, rows, used):
                    del c["counts"]
                    c["rows"], c["experts"] = int(n), int(e)
            out[entry] = calls
        self.calls = {}
        return out


def charge_gaps(spans: List[Tuple[int, int, str]],
                gap_list: List[Tuple[int, int]]) -> Dict[str, float]:
    """Seconds of each gap, summed by the innermost span open at the gap's
    start (spans of one thread nest, so a sweep with a stack finds it)."""
    marks = []
    for s, e, name in spans:
        marks.append((s, 1, name))
        marks.append((e, 0, name))
    for g0, g1 in gap_list:
        marks.append((g0, 2, g1 - g0))
    marks.sort(key=lambda m: (m[0], m[1]))
    stack: List[str] = []
    out: Dict[str, float] = {}
    for _, kind, val in marks:
        if kind == 1:
            stack.append(val)
        elif kind == 0:
            if val in stack:
                del stack[len(stack) - 1 - stack[::-1].index(val)]
        else:
            name = stack[-1] if stack else "outside any span"
            out[name] = out.get(name, 0.0) + val * 1e-9
    return out


def summarize(prof, t0_ns: int, t1_ns: int,
              spans: List[Tuple[int, int, str]]) -> Dict:
    """Busy seconds, seconds by kernel name, and the idle gaps charged to
    the host's ``spans``, from a finished profiler over ``[t0_ns, t1_ns)``."""
    dev: List[Tuple[int, int]] = []
    by_name: Dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_user_annotation():
            continue
        s, d = e.start_ns(), e.duration_ns()
        if d <= 0:
            continue
        dev.append((s, s + d))
        by_name[e.name()] = by_name.get(e.name(), 0.0) + d * 1e-9
    busy = win.union_length(dev) * 1e-9
    idle = charge_gaps(spans, win.gaps(dev, t0_ns, t1_ns))
    return {"busy_s": busy, "window_s": (t1_ns - t0_ns) * 1e-9,
            "kernel_s": by_name, "idle_s": idle, "device_events": len(dev)}


def kernel_seconds(kernel_s: Dict[str, float], pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(s for n, s in kernel_s.items() if rx.search(n))


def top(d: Dict[str, float], n: int = 10, width: int = 120) -> List[List]:
    return [[name[:width], s] for name, s in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class Traced:
    """Context for the traced window: the profiler (device activity only,
    so the host runs at its untraced pace), the spans on the host clock,
    the call recorder.  ``trace=False`` makes it a no-op."""

    def __init__(self, trace: bool, spans: Dict[str, Tuple[object, str]]):
        self.trace = trace
        self.spans = spans
        self.recorder = CallRecorder()
        self.summary: Optional[Dict] = None
        self.calls: Dict[str, List[Dict]] = {}
        self.host: List[Tuple[int, int, str]] = []

    def __enter__(self):
        if not self.trace:
            return self
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(patched(
            span_patches(self.spans, self.host) + self.recorder.patches()))
        acts = ([torch.profiler.ProfilerActivity.CUDA]
                if torch.cuda.is_available()
                else [torch.profiler.ProfilerActivity.CPU])
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if not self.trace:
            return False
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        self._stack.close()
        if exc[0] is None:
            self.summary = summarize(self.prof, self._t0, t1, self.host)
            self.calls = self.recorder.resolve()
        del self.prof
        return False
