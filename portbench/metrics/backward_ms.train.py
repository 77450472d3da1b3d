"""backward_ms.train: the device seconds of the work launched inside the
program's ``train.backward`` spans (``loss.backward()`` of one
microbatch, a remat's recompute included; its kernels launch from
autograd's worker thread) over the number of those spans, in ms per
microbatch."""
from portbench.program_spans import launched_within

NAME, UNIT, LAYER, MOVES = ("backward_ms.train", "ms", "model backward",
                            "train_tok_s")
SPAN = "train.backward"


def read(rec):
    seconds, events, spans = launched_within(rec, SPAN)
    if not events:
        return None
    return 1000.0 * seconds / spans
