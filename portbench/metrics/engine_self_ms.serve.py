"""Mean over the engine's working loop iterations (``engine.iter`` spans)
of their duration less the time spans of other layers below them cover
(model calls, pool spans, ``engine.readback``): the host's own work
between model calls, in ms, from the program's session of the traced
window."""
import numpy as np

from portbench import session, window

OTHER = ("model.", "pool.", "engine.readback")


def read(rec):
    s = session.last()
    if s is None:
        return None
    spans = s["spans"]
    by_id = {sp["id"]: sp for sp in spans if sp["id"] is not None}
    iters = {sp["id"]: [] for sp in spans if sp["name"] == "engine.iter"}
    if not iters:
        return None
    for sp in spans:
        if not sp["name"].startswith(OTHER):
            continue
        up = by_id.get(sp["parent"])
        while up is not None and up["name"] != "engine.iter":
            up = by_id.get(up["parent"])
        if up is not None:
            iters[up["id"]].append((sp["start_ns"], sp["end_ns"]))
    own = [by_id[i]["end_ns"] - by_id[i]["start_ns"]
           - window.union_length(cover) for i, cover in iters.items()]
    return float(np.mean(own)) * 1e-6
