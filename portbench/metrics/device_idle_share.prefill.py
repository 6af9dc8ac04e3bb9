"""device_idle_share.prefill (%, device trace): the share of the traced
window (first submission to the last call's logits on the host) in which
no activity runs on the device (the union of the kernels' and copies'
intervals)."""


def read(r):
    t = r.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
