"""Model operations of every prefill and decode token the window served
(``flops.serve_request``, each at its request's k)
over the window times the bf16 peak, in %."""
from portbench import readers


def read(rec):
    return readers.mfu(rec)
