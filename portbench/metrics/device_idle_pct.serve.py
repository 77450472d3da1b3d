"""device_idle_pct.serve: the share of the traced batches' ``generate``
calls in which no operation ran on the card, in % (the wait between
batches, which the schedule sets, is left out)."""
NAME, UNIT, LAYER, MOVES = ("device_idle_pct.serve", "%", "device",
                            "ttft_p95_s")
BATCH = "portbench.batch"


def read(rec):
    spans = rec.spans(BATCH)
    total = sum(e - s for s, e in spans) / 1e9
    if total <= 0 or not rec.device:
        return None
    return 100.0 * (1.0 - rec.busy_within(spans) / total)
