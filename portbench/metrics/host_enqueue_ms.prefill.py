"""host_enqueue_ms.prefill (ms, host clock): the median time from a call's
submission until `forward` returns, over the window's calls (no profiler
runs during the window).  Layer: host dispatch, eager PyTorch in
`models/model.py::forward`."""
import statistics


def read(r):
    enq = r.window.enqueue_s
    return statistics.median(enq) * 1e3 if enq else None
