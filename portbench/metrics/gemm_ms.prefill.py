"""gemm_ms.prefill (ms, device trace): device time a call, over the
profiled cycle of the mix, of the matrix product kernels (cuBLAS and
CUTLASS GEMMs: the projections, the MLP and the head of
`models/{layers,attention,ssm,moe}.py`), by kernel name."""

#: parts of the GEMM kernels' names as the profiler records them on the H100
NAMES = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "splitKreduce")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(n.lower() in low for n in NAMES)


def read(r):
    if r.trace is None:
        return None
    s = r.trace.per_call_s(is_gemm)
    return None if s is None else s * 1e3
