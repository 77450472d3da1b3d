"""attn_bwd_roofline.train: the attention backward's bound under the
bound rule (`roofline.counts.attn_bwd`, bf16 rates) over the device time
of the kernels launched under the autograd node
``FlashAttentionFnBackward``, in %."""
from portbench.roofline import counts

NAME, UNIT, LAYER, MOVES = ("attn_bwd_roofline.train", "%",
                            "attention backward", "train_tok_s")
NODE = "FlashAttentionFnBackward"


def read(rec):
    seconds, calls = rec.under_node(NODE)
    if not calls or seconds <= 0:
        return None
    c, m = rec.ctx, rec.ctx["m"]
    bound = counts.bound_s(*counts.attn_bwd(
        c["microbatch"], c["seq"], m["num_attention_heads"],
        m["num_key_value_heads"], m["head_dim"]))
    return 100.0 * bound * calls / seconds
