"""forward_ms.train: the device seconds of the work launched inside the
program's ``train.forward`` spans (the model's loss of one microbatch)
over the number of those spans, in ms per microbatch."""
from portbench.program_spans import launched_within

NAME, UNIT, LAYER, MOVES = ("forward_ms.train", "ms", "model forward",
                            "train_tok_s")
SPAN = "train.forward"


def read(rec):
    seconds, events, spans = launched_within(rec, SPAN)
    if not events:
        return None
    return 1000.0 * seconds / spans
