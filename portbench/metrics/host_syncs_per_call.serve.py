"""Host-device synchronisations the program makes inside its model calls
(``model.prefill`` and ``model.decode_step`` spans and below), per call,
from the program's session of the traced window."""
from portbench import session


def read(rec):
    return session.syncs_per_span(("model.prefill", "model.decode_step"))
