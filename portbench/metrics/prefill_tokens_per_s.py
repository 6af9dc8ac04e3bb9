"""prefill_tokens_per_s (tokens/s, host clock): every prompt token of the
window's calls over the window's seconds (first submission to the last
call's logits on the host)."""


def read(r):
    w = r.window
    if not w.calls:
        return None
    return w.tokens / w.seconds
