"""optimizer_ms.train: the device seconds of the work launched inside the
program's ``train.optimizer`` spans (the gradients' average over the
microbatches, compression and the update) over the number of those
spans, in ms per step."""
from portbench.program_spans import launched_within

NAME, UNIT, LAYER, MOVES = ("optimizer_ms.train", "ms", "optimizer",
                            "train_tok_s")
SPAN = "train.optimizer"


def read(rec):
    seconds, events, spans = launched_within(rec, SPAN)
    if not events:
        return None
    return 1000.0 * seconds / spans
