"""flash_launches.prefill (count, program counter): launches a call of the
flash kernel's tensor-core route, `LAUNCHES["flash_wgmma"]` of
`kernels/flash_attention/kernel.py`, over the window (the route chosen by
`kernel.py::choose_route` behind `models/attention.py::sdpa`)."""


def read(r):
    n = r.window.counters.get("flash_attention.flash_wgmma")
    if n is None or not r.window.calls:
        return None
    return n / r.window.calls
