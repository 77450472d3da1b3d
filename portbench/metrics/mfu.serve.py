"""mfu.serve: the model FLOPs of the measured window's batches (prefill
and decode steps, `roofline.counts.serve_flops`) over the host time of
their ``generate`` calls (untraced) at the dense bf16 peak of the
window's H100s (``chips`` of them), in %."""
from portbench.roofline import counts

NAME, UNIT, LAYER, MOVES = "mfu.serve", "%", "serving engine", "ttft_p95_s"


def read(rec):
    c, w = rec.ctx, rec.ctx["window"]
    if not w.get("serve_s"):
        return None
    steps_a_batch = w["decode_steps"] / w["batches"]
    flops = counts.serve_flops(c["family"], c["m"], w["rows"], w["seq"],
                               steps_a_batch)
    return 100.0 * flops * w["batches"] / (
        sum(w["serve_s"]) * (w["chips"] * counts.PEAK_FLOPS_BF16))
