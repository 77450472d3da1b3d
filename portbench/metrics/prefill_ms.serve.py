"""prefill_ms.serve: the device seconds of the work launched inside the
program's ``serve.prefill`` spans (a batch's prefill and its logits)
over the number of those spans, in ms per batch."""
from portbench.program_spans import launched_within

NAME, UNIT, LAYER, MOVES = ("prefill_ms.serve", "ms", "model forward",
                            "ttft_p95_s")
SPAN = "serve.prefill"


def read(rec):
    seconds, events, spans = launched_within(rec, SPAN)
    if not events:
        return None
    return 1000.0 * seconds / spans
