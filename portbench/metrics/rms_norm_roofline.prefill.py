"""rms_norm_roofline.prefill (%, device trace): the least time of the
profiled calls' RMS norms of the residual stream over the device time of
the RMS-norm kernel (`kernels/rms_norm/csrc/rms_norm.cu`) in those calls,
by kernel name.  The least time is the norms' bytes at HBM bandwidth
(`bytes_per_call`); ~5 operations a value are ~2 a byte in bf16, far
below the ridge, so the operations set no bound.  Only the residual
stream's norms and the final norm are counted, so a model with other
norms on the kernel (MLA's latents) would read low, never high.  Silent
where the trace has no such kernel (as before the kernel existed)."""
from portbench.roofline import HBM_BYTES_PER_S

#: the kernel's name, as the profiler records it, contains this
NAME = "rms_norm_kernel"
ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def norms_per_call(m: dict) -> int:
    """The residual stream's RMS norms of one `forward`: one a block in a
    Mamba2 model (family "ssm"), two a block elsewhere (before the mixer
    and before the MLP), and the final norm; 0 for a model whose norm is
    not RMS."""
    if m.get("norm", "rmsnorm") != "rmsnorm":
        return 0
    return m["n_layers"] * (1 if m["family"] == "ssm" else 2) + 1


def bytes_per_call(m: dict, b: int, t: int) -> int:
    """The bytes the norms of one `forward(tokens [b, t])` must move: each
    reads x [b t, d_model] and writes its output once in the compute type,
    and reads its weight [d_model] once in the parameters' type (the final
    norm runs over every position, before the last is taken)."""
    d = m["d_model"]
    norm = b * t * d * 2 * ESIZE[m["compute_dtype"]] \
        + d * ESIZE[m["param_dtype"]]
    return norms_per_call(m) * norm


def read(r):
    if r.trace is None:
        return None
    t = r.trace.per_call_s(lambda name: NAME in name)
    nbytes = sum(bytes_per_call(r.cell.model, b, s)
                 for b, s in r.traced_shapes)
    if not t or not nbytes:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / (t * r.trace.calls)
