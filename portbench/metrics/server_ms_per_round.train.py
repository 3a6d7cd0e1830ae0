"""Device time of the server's own work per round: the sum of ``dev_ms``
(CUDA event markers at the span's start and end) over the ``distribute``,
``agg.flame_acc_update`` and ``aggregate`` spans, over the ``round N``
spans, in ms, from the program's session of the traced window."""
from portbench import session

NAMES = ("distribute", "agg.flame_acc_update", "aggregate")


def read(rec):
    s = session.last()
    if s is None:
        return None
    rounds = sum(sp["name"].startswith("round ") for sp in s["spans"])
    dev = [sp.get("dev_ms") for sp in s["spans"] if sp["name"] in NAMES]
    if not rounds or not dev or any(d is None for d in dev):
        return None
    return sum(dev) / rounds
