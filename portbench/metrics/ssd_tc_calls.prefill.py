"""ssd_tc_calls.prefill (count, program counter): SSD op calls a call on
route "tc", `LAUNCHES["ssd_tc"]` of `kernels/ssd_scan/kernel.py`, over the
window (the route chosen by `kernel.py::choose_route` behind
`kernels/ssd_scan/ops.py::ssd_scan`)."""


def read(r):
    n = r.window.counters.get("ssd_scan.ssd_tc")
    if n is None or not r.window.calls:
        return None
    return n / r.window.calls
