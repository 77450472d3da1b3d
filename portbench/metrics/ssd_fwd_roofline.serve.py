"""ssd_fwd_roofline.serve: the SSD scan's bound at the prefill's
shape (`roofline.counts.ssd_fwd`, bf16 rates) times its calls over the
stretch (the program's kernel counter) over the summed device time of
the SSD kernel's launches, in %."""
from portbench.roofline import counts

NAME, UNIT, LAYER, MOVES = ("ssd_fwd_roofline.serve", "%",
                            "SSD scan kernel", "ttft_p95_s")
KERNELS = r"\bssd_(states|carry|out)"


def read(rec):
    seconds, _ = rec.kernel_seconds(KERNELS)
    calls = rec.calls.get("ssd_scan", 0)
    if not calls or seconds <= 0:
        return None
    c, m = rec.ctx, rec.ctx["m"]
    di = m["expand"] * m["d_model"]
    bound = counts.bound_s(*counts.ssd_fwd(
        c["rows"], c["seq"], di // m["headdim"], m["headdim"],
        m["d_state"], m["chunk_size"]))
    return 100.0 * bound * calls / seconds
