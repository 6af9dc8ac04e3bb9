"""ssm_gate_fused_calls.prefill (count, program counter): launches a call
of the Mamba2 gate chain's kernel, `LAUNCHES["fused"]` of
`kernels/ssm_gate/kernel.py`, over the window (one a Mamba2 layer when
`models/ssm.py::mamba2_forward` takes `kernels/ssm_gate/ops.py::ssm_gate`'s
kernel).  Silent where the program has no such counter."""


def read(r):
    n = r.window.counters.get("ssm_gate.fused")
    if n is None or not r.window.calls:
        return None
    return n / r.window.calls
