"""What the readers of the program's own spans share.

A ``torch.profiler`` window opens a session in the program
(``repro_torch.obs.trace``): the engine and the server record their layer
spans, the device time between the markers of the spans that enqueue
device work (``dev_ms``), the host syncs and the KV cache's row counts.
:func:`last` reads it once the window has closed.  A program without such
a session, or a run that recorded no span (every ``--trace 0`` run), gives
None, so each reader then returns None.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set


def last() -> Optional[Dict]:
    """The program's newest session record, or None."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return None
    read = getattr(trace, "last_session", None)
    if read is None:
        return None
    rec = read()
    return rec if rec and rec.get("spans") else None


def under(spans: List[Dict], names: Iterable[str]) -> Set[int]:
    """Ids of the spans named in ``names`` and of every span below them."""
    kids: Dict[int, List[int]] = {}
    for sp in spans:
        if sp["id"] is not None and sp["parent"] is not None:
            kids.setdefault(sp["parent"], []).append(sp["id"])
    names = set(names)
    todo = [sp["id"] for sp in spans
            if sp["name"] in names and sp["id"] is not None]
    out: Set[int] = set()
    while todo:
        i = todo.pop()
        if i not in out:
            out.add(i)
            todo += kids.get(i, [])
    return out


def syncs_per_span(names: Iterable[str]) -> Optional[float]:
    """Host syncs made inside spans named in ``names`` (or below them),
    per such span."""
    rec = last()
    if rec is None:
        return None
    names = tuple(names)
    n_spans = sum(sp["name"] in names for sp in rec["spans"])
    if not n_spans:
        return None
    inside = under(rec["spans"], names)
    return sum(y["span"] in inside for y in rec["syncs"]) / n_spans
