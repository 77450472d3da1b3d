"""ssd_bwd_roofline.train: the SSD backward's bound under the bound
rule (`roofline.counts.ssd_bwd`, bf16 rates) over the device time of the
kernels launched under the autograd node ``SSDScanFnBackward``, in %."""
from portbench.roofline import counts

NAME, UNIT, LAYER, MOVES = ("ssd_bwd_roofline.train", "%",
                            "SSD backward", "train_tok_s")
NODE = "SSDScanFnBackward"


def read(rec):
    seconds, calls = rec.under_node(NODE)
    if not calls or seconds <= 0:
        return None
    c, m = rec.ctx, rec.ctx["m"]
    di = m["expand"] * m["d_model"]
    bound = counts.bound_s(*counts.ssd_bwd(
        c["microbatch"], c["seq"], di // m["headdim"], m["headdim"],
        m["d_state"], m["chunk_size"]))
    return 100.0 * bound * calls / seconds
