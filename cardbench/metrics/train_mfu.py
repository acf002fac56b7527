"""train_mfu: the model operations of the window's steps (the benchmark's
own count, ``yardstick.train_flops``: 6 N tokens + 12 L B S^2 H hd) over
the window's seconds on the host clock, as a share of the card's bf16
peak."""

from cardbench import yardstick


def read(r):
    steps = r.window.get("steps")
    if not steps:
        return None
    t = r.run.traffic
    flops = steps * yardstick.train_flops(r.run.cfg, t["batch"], t["seq"])
    return 100.0 * flops / r.window["window_s"] / yardstick.PEAK_BF16_FLOP_S
