"""``mfu``: the operations the recipe's step needs (``h100bench/counts.py``:
convolutions, dense layers, attention products; forward and the gradients
the recipe takes) times the steps completed in the window, over the
window's seconds, over the card's peak in the configuration's compute
dtype."""


def read(r):
    peak = (r["peaks"] or {}).get(r["dtype"])
    if not peak or r["window_s"] <= 0:
        return None
    return (100.0 * r["ops_per_step"] * r["window_steps"] / r["window_s"]
            / peak)
