"""Host ms from the call of `make_multi_train_step`'s step to its return
(the step waits on the device once, for the finite flags): the median
over the traced steps."""

import statistics


def read(rec):
    if rec["kind"] != "train" or not rec["issue_ms"]:
        return None
    return statistics.median(rec["issue_ms"])
