"""device_idle_pct.train: the share of the traced training steps in which
no operation ran on the card, in %."""
NAME, UNIT, LAYER, MOVES = "device_idle_pct.train", "%", "device", "train_tok_s"


def read(rec):
    if rec.window_s <= 0 or not rec.device:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
