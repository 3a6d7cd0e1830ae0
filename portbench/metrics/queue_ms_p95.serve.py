"""95th percentile over the window's requests of the wait from the due
arrival to the start of their prefill call (the scheduler's queue, on the
benchmark's clock, from raw samples), in ms."""
from portbench import window


def read(rec):
    xs = rec.get("run", {}).get("queue_s")
    return window.percentile(xs, 95) * 1e3 if xs else None
