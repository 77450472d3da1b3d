"""decode_step_ms.serve: the serving engine's own decode time
(`ServeEngine.stats`: ``decode_s``, device-synced) over its decode steps
in the measured window (untraced), in ms."""
NAME, UNIT, LAYER, MOVES = ("decode_step_ms.serve", "ms", "serving engine",
                            "ttft_p95_s")


def read(rec):
    w = rec.ctx["window"]
    if not w.get("decode_steps"):
        return None
    return 1000.0 * w["decode_s"] / w["decode_steps"]
