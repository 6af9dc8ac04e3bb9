"""setup_s (s, host clock): from the harness's first line to the window's
first call: imports, the card's start, the kernels' build on a checkout's
first run, the weights made from the seed, the warm-up calls."""


def read(r):
    return r.setup_s
