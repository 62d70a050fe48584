"""``groupnorm_roofline``: the bytes GroupNorm needs from the shapes (each
input read once, each output written once, forward and backward, at the
activation dtype; ``h100bench/counts.py``) over the memory bandwidth, over
the device time of what the GroupNorm modules launched (their float32
casts included) and of their backward, in the traced stretch."""


def read(r):
    bw = (r["peaks"] or {}).get("bytes_per_s")
    t = r["stretch"]["layers"].get("groupnorm", 0.0)
    if not bw or t <= 0:
        return None
    return 100.0 * r["bytes"]["groupnorm"] * r["stretch_steps"] / bw / t
