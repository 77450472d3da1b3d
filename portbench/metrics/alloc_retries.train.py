"""alloc_retries.train: the program's counter ``train.alloc_retries``
(`repro_torch.spans.COUNTS`: the caching allocator's retries, each a
free of the cached blocks and a new cudaMalloc, counted over
every ``train.step`` on the card while the profiler records; one traced
stretch a run) over the number of ``train.step`` spans in the record, in
retries per step."""
NAME, UNIT, LAYER, MOVES = ("alloc_retries.train", "retries", "allocator",
                            "train_tok_s")
SPAN, COUNTER = "train.step", "train.alloc_retries"


def read(rec):
    steps = len(rec.spans(SPAN))
    if not steps or not rec.device:
        return None
    try:
        from repro_torch.spans import COUNTS
    except ImportError:
        return None
    if COUNTER not in COUNTS:
        return None
    return COUNTS[COUNTER] / steps
