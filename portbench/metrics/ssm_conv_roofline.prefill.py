"""ssm_conv_roofline.prefill (%, device trace): the least time of the
profiled calls' Mamba2 conv chains over the device time of the conv-chain
kernel (`kernels/ssm_conv/csrc/ssm_conv.cu`) in those calls, by kernel
name.  The least time is each Mamba2 layer's bytes at HBM bandwidth
(`bytes_per_call`); the chain's K multiply-adds and one exp a channel are
~0.3 operations a byte, far below the ridge, so its operations set no
bound.  Silent where the model has no Mamba2 layer or the trace no such
kernel (as before the kernel existed)."""
from portbench.roofline import HBM_BYTES_PER_S

#: the kernel's name, as the profiler records it, contains this
NAME = "ssm_conv_kernel"
ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bytes_per_call(m: dict, b: int, t: int) -> int:
    """The bytes the conv chains of one `forward(tokens [b, t])` must
    move: a layer reads the conv's C = d_inner + 2 G N and dt's H columns
    of in_proj's output once in the compute type, writes the float32 conv
    output and dt once, and reads its conv weights and bias and dt's bias
    ((K + 1) C + H) once; 0 for a model with no Mamba2 layer."""
    if "d_state" not in m:
        return 0
    di = m["expand"] * m["d_model"]
    c = di + 2 * m["ssm_ngroups"] * m["d_state"]
    h = di // m["ssm_headdim"]
    e = ESIZE[m["compute_dtype"]]
    layer = b * t * (c + h) * (e + 4) + ((m["d_conv"] + 1) * c + h) * e
    return m["n_layers"] * layer


def read(r):
    if r.trace is None:
        return None
    t = r.trace.per_call_s(lambda name: NAME in name)
    nbytes = sum(bytes_per_call(r.cell.model, b, s)
                 for b, s in r.traced_shapes)
    if not t or not nbytes:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / (t * r.trace.calls)
