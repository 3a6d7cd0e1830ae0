"""Host-device synchronisations the program makes inside its client
steps (``client.step`` spans and below), per step, from the program's
session of the traced window."""
from portbench import session


def read(rec):
    return session.syncs_per_span(("client.step",))
