"""Mean over the window's requests of their prefill call's start to the
engine's next model call, when the first token is on the host (the
benchmark's clock round the program's ``model.prefill``), in ms."""
import numpy as np


def read(rec):
    xs = rec.get("run", {}).get("prefill_s")
    return float(np.mean(xs)) * 1e3 if xs else None
