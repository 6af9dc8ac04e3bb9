"""ssd_roofline.prefill (%, device trace): the least time of the profiled
calls' SSD scans (every scan of `roofline/<reference>.py`'s `work` at each
call's [B, T], each product once at the TF32 peak or its float32 bytes,
`roofline.ssd_bound_s`) over the device time of the SSD kernels
(`csrc/ssd_scan.cu`, both routes) in those calls, by kernel name.  Silent
where the model has no scan or the trace no SSD kernel."""
from portbench import roofline

#: the SSD kernels' names: route "tc" (five launches) and route "simt"
NAMES = ("ssd_prep_kernel", "ssd_cb_kernel", "ssd_states_kernel",
         "ssd_pass_kernel", "ssd_out_kernel", "ssd_fwd_kernel")


def is_ssd(name: str) -> bool:
    return any(n in name for n in NAMES)


def read(r):
    if r.trace is None:
        return None
    shapes = r.work(r.traced_shapes)["ssd"]
    t = r.trace.per_call_s(is_ssd)
    if not shapes or not t:
        return None
    return 100.0 * sum(roofline.ssd_bound_s(*s)[0] for s in shapes) \
        / (t * r.trace.calls)
