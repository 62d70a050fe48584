"""``device_idle``: the share of a step in which the device runs nothing:
``1 - busy / period``, with the device's busy seconds a step (kernels,
copies and sets, overlaps once) from the first traced stretch, where the
profiler records the device alone, and the step's period from the
untraced window.  The stretch's own wall is not the period: recording
every launch slows a host-paced loop."""


def read(r):
    st = r["stretch"]
    if st["busy_s"] <= 0 or r["window_steps"] <= 0:
        return None
    busy = st["busy_s"] / r["stretch_steps"]
    period = r["window_s"] / r["window_steps"]
    return 100.0 * (1.0 - busy / period)
