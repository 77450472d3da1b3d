"""decode_launches.serve: the device events (kernels, copies and sets)
launched inside the program's ``serve.decode`` spans (one decode step:
the model's step, the token chosen) over the number of those spans, in
launches per step: the host's work a step that CUDA graphs would
replace."""
from portbench.program_spans import launched_within

NAME, UNIT, LAYER, MOVES = ("decode_launches.serve", "launches",
                            "serving engine", "ttft_p95_s")
SPAN = "serve.decode"


def read(rec):
    _, events, spans = launched_within(rec, SPAN)
    if not events:
        return None
    return events / spans
