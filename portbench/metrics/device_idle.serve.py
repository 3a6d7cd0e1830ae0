"""Share of the traced window in which no operation ran on the device
(1 - union of device intervals / window), in %."""
from portbench import readers


def read(rec):
    return readers.idle(rec)
