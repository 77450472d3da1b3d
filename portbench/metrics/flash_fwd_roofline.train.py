"""flash_fwd_roofline.train: the flash attention forward's bound
(with its log-sum-exp, `roofline.counts.flash_fwd`, bf16 rates) times
its calls over the stretch (the program's kernel counter) over the
summed device time of the ``flash_fwd`` kernels, in %."""
from portbench.roofline import counts

NAME, UNIT, LAYER, MOVES = ("flash_fwd_roofline.train", "%",
                            "flash attention kernel", "train_tok_s")


def read(rec):
    seconds, launches = rec.kernel_seconds(r"flash_fwd")
    calls = rec.calls.get("flash_attention", 0)
    if not calls or seconds <= 0:
        return None
    c, m = rec.ctx, rec.ctx["m"]
    bound = counts.bound_s(*counts.flash_fwd(
        c["microbatch"], c["seq"], m["num_attention_heads"],
        m["num_key_value_heads"], m["head_dim"]))
    return 100.0 * bound * calls / seconds
