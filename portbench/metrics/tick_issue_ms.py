"""Host ms from the call of `MobilePoserNet.forward_online_batched` to its
return, before the wait on the tick's copy: the median over the traced
ticks."""

import statistics


def read(rec):
    if rec["kind"] != "stream" or not rec["issue_ms"]:
        return None
    return statistics.median(rec["issue_ms"])
