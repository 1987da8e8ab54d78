"""Kernels #1 and #2: the least time of the traced ticks' layer-scans
(`roofline.stream_scan_bound_ms`) over the device time of the scan
kernels, in %."""

from portbench import roofline, trace


def read(rec):
    if rec["kind"] != "stream":
        return None
    us = trace.op_us(rec["trace"], trace.is_scan)
    calls = len(rec["trace"]["calls"])
    if us <= 0 or not calls:
        return None
    bound_ms = roofline.stream_scan_bound_ms(rec["cfg"],
                                             rec["traffic"]["streams"])
    return 100.0 * bound_ms * calls / (us / 1e3)
