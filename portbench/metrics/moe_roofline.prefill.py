"""moe_roofline.prefill (%, device trace): the least time of the profiled
calls' routed-expert products (every MoE layer's gate, up and down
products over the tokens x top_k rows, the "moe" shapes of
`roofline/<reference>.py`'s `work` at each call's [B, S];
`roofline/granite_hybrid.py::grouped_bound_s`, bound by its operations
at the bf16 peak at these shapes) over the device time of the grouped
GEMM kernels (`torch._grouped_mm`, behind
`kernels/moe_grouped/kernel.py`) in those calls, by kernel name.  Silent
where the model has no routed experts or the trace no such kernel."""
from portbench.roofline.granite_hybrid import grouped_bound_s

#: the grouped GEMM's kernel name, as the profiler records it on the H100
#: (CUTLASS's sm90 grouped GEMM inside PyTorch), contains this
NAME = "GroupProblemShape"


def read(r):
    if r.trace is None:
        return None
    shapes = [x for b, s in r.traced_shapes
              for x in r.cell.work(r.cell.model, b, s).get("moe", [])]
    t = r.trace.per_call_s(lambda name: NAME in name)
    if not shapes or not t:
        return None
    return 100.0 * sum(grouped_bound_s(*x)[0] for x in shapes) \
        / (t * r.trace.calls)
