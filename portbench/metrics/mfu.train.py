"""mfu.train: the training step's model FLOPs (6 × active parameters ×
tokens + 3 × the forward's token-mixing products, `roofline.counts`)
over the measured window's time (the first step's start to the last
step's end, as ``train_tok_s``, untraced) at the dense bf16 peak of the
window's H100s (``chips`` of them), in %."""
from portbench.roofline import counts

NAME, UNIT, LAYER, MOVES = "mfu.train", "%", "train step", "train_tok_s"


def read(rec):
    c, w = rec.ctx, rec.ctx["window"]
    if not w.get("steps"):
        return None
    flops = counts.train_step_flops(c["family"], c["m"], w["rows"], w["seq"])
    return 100.0 * flops * w["steps"] / (
        w["window_s"] * (w["chips"] * counts.PEAK_FLOPS_BF16))
