"""``haar_roofline``: the Haar pyramid's bytes (its input read once, every
level below it written once; ``h100bench/counts.py``) over the memory
bandwidth, over the device time of what the program's ``haar_pyramid``
launched, in the traced stretch."""


def read(r):
    bw = (r["peaks"] or {}).get("bytes_per_s")
    t = r["stretch"]["layers"].get("haar", 0.0)
    if not bw or t <= 0:
        return None
    return 100.0 * r["bytes"]["pyramid"] * r["stretch_steps"] / bw / t
