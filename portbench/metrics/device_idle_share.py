"""device_idle_share: the share of the traced window in which no operation
ran on the card, 1 - (union of the device's operation intervals) / window."""


def read(rec):
    dev = rec["device"]
    if not dev.get("busy_s"):
        return None
    return 1.0 - dev["busy_s"] / dev["window_s"]
