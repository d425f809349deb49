"""device_idle_share (%): the share of the traced window in which no
operation ran on the card: 100 - the union of the device operations'
intervals over the window. Moves ticks_per_s."""


def read(tr):
    if tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
