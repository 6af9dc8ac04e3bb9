"""elementwise_ms.prefill (ms, device trace): device time a call, over the
profiled cycle of the mix, of ATen's element-wise, copy and reduction
kernels: norms, RoPE, activations, casts, the residual adds, the embedding
gather and the Mamba2 layer's float32 islands in `models/ssm.py`, by
kernel name."""

#: parts of ATen's kernel names as the profiler records them
NAMES = ("elementwise_kernel", "reduce_kernel", "CatArrayBatchedCopy",
         "indexSelect", "index_elementwise", "vectorized_gather",
         "at::native::", "copy_kernel")
#: names that contain one of NAMES but are not element-wise work
NOT = ("gemm", "nvjet", "flash_", "ssd_")


def is_elementwise(name: str) -> bool:
    return any(n in name for n in NAMES) and not any(n in name for n in NOT)


def read(r):
    if r.trace is None:
        return None
    s = r.trace.per_call_s(is_elementwise)
    return None if s is None else s * 1e3
