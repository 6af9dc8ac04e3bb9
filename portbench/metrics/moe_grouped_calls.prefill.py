"""moe_grouped_calls.prefill (count, program counter): launches a call of
the routed experts' grouped products, `LAUNCHES["grouped"]` of
`kernels/moe_grouped/kernel.py`, over the window (three a dropless MoE
layer, gate, up and down, when `models/moe.py` takes
`kernels/moe_grouped/ops.py::grouped_mm`'s grouped GEMM).  Silent where
the program has no such counter."""


def read(r):
    n = r.window.counters.get("moe_grouped.grouped")
    if n is None or not r.window.calls:
        return None
    return n / r.window.calls
