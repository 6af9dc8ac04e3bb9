"""rms_norm_fused_calls.prefill (count, program counter): launches a call
of the RMS-norm kernel, `LAUNCHES["fused"]` of
`kernels/rms_norm/kernel.py`, over the window (one a norm of the residual
stream and the final norm when `models/layers.py::rms_norm` takes
`kernels/rms_norm/ops.py::rms_norm`'s kernel: 2 a block and 1 in phi3 and
granite, 1 a block and 1 in mamba2).  Silent where the program has no such
counter."""


def read(r):
    n = r.window.counters.get("rms_norm.fused")
    if n is None or not r.window.calls:
        return None
    return n / r.window.calls
