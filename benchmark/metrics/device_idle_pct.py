"""``device_idle_pct.<cell kind>``: share of the traced requests' span in
which no kernel, copy or fill ran on the device, in %."""


def read(view):
    if view is None or view.trace.window_s <= 0 or not view.trace.device:
        return None
    return 100.0 * (1.0 - view.trace.busy_s() / view.trace.window_s)
