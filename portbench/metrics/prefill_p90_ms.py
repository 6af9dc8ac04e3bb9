"""prefill_p90_ms (ms, host clock): the 90th percentile of the latency of
every call of the window, from its submission to its last-position logits on
the host (`statistics.quantiles`, inclusive method)."""
import statistics


def read(r):
    lat = r.window.latency_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8] * 1e3
