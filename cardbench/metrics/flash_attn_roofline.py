"""flash_attn_roofline: the least time the traced slice's flash-attention
calls could take on the card (each call's operations at the bf16 peak or
its bytes at HBM's, whichever is larger; ``yardstick``) over the device
time of the flash kernels in the trace, in percent.  Nothing is read
where the trace holds none of them, or where the port counted other
launches than the calls the slice makes."""

from cardbench import yardstick

#: kernel names of the port's flash-attention libraries
KERNELS = ("flash_attention_wgmma", "flash_attention_tf32x3")


def read(r):
    if r.summary is None or not r.traced or "flash_calls" not in r.traced:
        return None
    calls = r.traced["flash_calls"]
    if r.traced["flash_launches"] != len(calls):
        return None
    device_s = r.summary.device_us(KERNELS) / 1e6
    if device_s <= 0:
        return None
    bound_s = sum(yardstick.attention_roofline_s(*c) for c in calls)
    return 100.0 * bound_s / device_s
