"""flash_roofline.prefill (%, device trace): the least time of the profiled
calls' attention work (every attention layer of `roofline/<reference>.py`'s
`work` at each call's [B, S], causal and bf16, `roofline.flash_bound_s`)
over the device time of the flash kernels (`csrc/flash_attention.cu`) in
those calls, by kernel name.  Silent where the model has no such layer or
the trace no flash kernel."""
from portbench import roofline

#: the flash kernels' names: the tensor-core and the SIMT route
NAMES = ("flash_fwd_tc_kernel", "flash_fwd_kernel")


def is_flash(name: str) -> bool:
    return any(n in name for n in NAMES)


def read(r):
    if r.trace is None:
        return None
    shapes = r.work(r.traced_shapes)["flash"]
    t = r.trace.per_call_s(is_flash)
    if not shapes or not t:
        return None
    return 100.0 * sum(roofline.flash_bound_s(*s)[0] for s in shapes) \
        / (t * r.trace.calls)
