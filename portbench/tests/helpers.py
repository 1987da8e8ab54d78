"""Small traffic for CPU runs of the harness."""

from portbench import manifest


def small_traffic(man: manifest.Manifest, cell: str, **over) -> dict:
    tr = man.traffic(man.cell(cell)["traffic"])
    if tr["kind"] == "stream":
        tr.update(streams=4, period_ticks=16, warmup_ticks=2, trace_calls=2,
                  check_streams=4)
    else:
        tr.update(batch=2, window=12, pool=3, warmup_steps=1, trace_calls=1)
    tr.update(over)
    return tr
