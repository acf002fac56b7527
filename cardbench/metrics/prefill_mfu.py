"""prefill_mfu: the model operations of the window's prefills (the
benchmark's own count, ``yardstick.prefill_flops``) over the window's
seconds on the host clock, as a share of the card's bf16 peak."""

from cardbench import yardstick


def read(r):
    prefills = r.window.get("prefills")
    if not prefills:
        return None
    flops = sum(yardstick.prefill_flops(r.run.cfg, rows, length)
                for rows, length in prefills)
    return 100.0 * flops / r.window["window_s"] / yardstick.PEAK_BF16_FLOP_S
