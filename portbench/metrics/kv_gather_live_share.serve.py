"""Share of the K/V rows the decode steps' paged gathers copy that hold
live positions: the KV cache's ``kv.rows_live`` over ``kv.rows_gathered``
(counted from host integers where each step's block table is built), in
%, from the program's session of the traced window."""
from portbench import session


def read(rec):
    s = session.last()
    if s is None:
        return None
    c = s.get("counters", {})
    gathered = c.get("kv.rows_gathered")
    if not gathered:
        return None
    return 100.0 * c.get("kv.rows_live", 0) / gathered
