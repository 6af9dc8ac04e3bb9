"""ssm_gate_roofline.prefill (%, device trace): the least time of the
profiled calls' Mamba2 gate chains over the device time of the gate-chain
kernel (`kernels/ssm_gate/csrc/ssm_gate.cu`) in those calls, by kernel
name.  The least time is each Mamba2 layer's bytes at HBM bandwidth
(`bytes_per_call`); the chain's ~20 operations and one exp a channel are
under two operations a byte, far below the ridge, so its operations set
no bound.  Silent where the model has no Mamba2 layer or the trace no
such kernel (as before the kernel existed)."""
from portbench.roofline import HBM_BYTES_PER_S

#: the kernel's name, as the profiler records it, contains this
NAME = "ssm_gate_kernel"
ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def mamba_layers(m: dict) -> int:
    """The model's Mamba2 layers: those `layer_types` names "mamba" where
    the configuration has the key (a hybrid), else all `n_layers`."""
    if "layer_types" in m:
        return m["layer_types"].count("mamba")
    return m["n_layers"]


def bytes_per_call(m: dict, b: int, t: int) -> int:
    """The bytes the gate chains of one `forward(tokens [b, t])` must
    move: a layer reads the scan's output y and its input xh (float32) and
    in_proj's z columns (the compute type) once, writes the output (the
    compute type) once, and reads out_norm [d_inner] and D [H] once; 0 for
    a model with no Mamba2 layer."""
    if "d_state" not in m:
        return 0
    di = m["expand"] * m["d_model"]
    h = di // m["ssm_headdim"]
    e = ESIZE[m["compute_dtype"]]
    layer = b * t * di * (4 + 4 + 2 * e) + di * e + h * e
    return mamba_layers(m) * layer


def read(r):
    if r.trace is None:
        return None
    t = r.trace.per_call_s(lambda name: NAME in name)
    nbytes = sum(bytes_per_call(r.cell.model, b, s)
                 for b, s in r.traced_shapes)
    if not t or not nbytes:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / (t * r.trace.calls)
