"""Model operations of the window's client steps (``flops.train_step``)
over the window times the bf16 peak, in %."""
from portbench import readers


def read(rec):
    return readers.mfu(rec)
