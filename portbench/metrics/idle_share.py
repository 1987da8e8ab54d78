"""Share of a stream cell's traced window in which no device operation
ran: 1 - the union of their intervals over the window, in %."""

from portbench import trace


def read(rec):
    return trace.idle_share(rec, "stream")
