"""``device_idle_pct`` (%, layer: device): the share of the traced window
in which no kernel, memcpy or memset ran on the card, from the union of
their intervals. Moves ``frames_per_s``."""


def read(t):
    if not t.device or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)
