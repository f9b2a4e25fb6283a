"""device_idle_pct: the share of the traced window in which no operation
ran on the card (kernel, copy or fill), averaged over the cards the cell
uses. Layer: device."""


def read(view):
    if not view.device_events:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)
