"""``conv_roofline``: the convolutions' operations from the shapes
(``h100bench/counts.py``) over the device time of the kernels that the
convolution operations launched (forward and backward; ``devtrace``
links each kernel to its launch), over the peak in the compute dtype, in
the traced stretch."""


def read(r):
    peak = (r["peaks"] or {}).get(r["dtype"])
    t = r["stretch"]["layers"].get("conv", 0.0)
    if not peak or t <= 0:
        return None
    return 100.0 * r["ops"]["conv"] * r["stretch_steps"] / t / peak
