"""ssd_fwd_roofline.train: the SSD scan's bound (`roofline.counts.
ssd_fwd`, bf16 rates) times its calls over the stretch (the program's
kernel counter: the forward's and the recompute's) over the summed
device time of the SSD kernel's launches (``ssd_states``, ``ssd_carry``,
``ssd_out``), in %."""
from portbench.roofline import counts

NAME, UNIT, LAYER, MOVES = ("ssd_fwd_roofline.train", "%",
                            "SSD scan kernel", "train_tok_s")
KERNELS = r"\bssd_(states|carry|out)"


def read(rec):
    seconds, _ = rec.kernel_seconds(KERNELS)
    calls = rec.calls.get("ssd_scan", 0)
    if not calls or seconds <= 0:
        return None
    c, m = rec.ctx, rec.ctx["m"]
    di = m["expand"] * m["d_model"]
    bound = counts.bound_s(*counts.ssd_fwd(
        c["microbatch"], c["seq"], di // m["headdim"], m["headdim"],
        m["d_state"], m["chunk_size"]))
    return 100.0 * bound * calls / seconds
