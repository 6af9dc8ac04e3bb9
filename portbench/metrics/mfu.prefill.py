"""mfu.prefill (%, host clock): the model's operations in the window's
calls (the "flops" of `roofline/<reference>.py`'s `work` at each call's
[B, S]) over the window's seconds, as a share of the H100's bf16 dense
peak (989 TFLOP/s)."""
from portbench import roofline


def read(r):
    w = r.window
    if not w.calls:
        return None
    return 100.0 * r.work(w.shapes)["flops"] / w.seconds \
        / roofline.PEAK_BF16_FLOP_PER_S
