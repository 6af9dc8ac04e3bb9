"""What every kernel wrapper shares (`repro_torch.kernels.build`), on the
CPU: `aligned`, the 16-byte rule that the flash and SSD routes, the conv
and gate wrappers' vector accesses, the grouped GEMM and the mapspace
kernel each ask of their inputs, and `needs_grad`, the rule by which the
Mamba2 ops take their plain versions and the wrappers raise.  The launcher
runs on the card (the `gpu` tests of every wrapper).  No JAX here."""
import pytest
import torch

from repro_torch.kernels.build import aligned, needs_grad


def _rows(cols, rows=(2, 8), dtype=torch.bfloat16, start=0):
    """A [B, T, cols] view of a fresh buffer, starting `start` elements
    in (the allocator's blocks start 64-byte aligned)."""
    n = rows[0] * rows[1] * cols
    return torch.zeros(n + start, dtype=dtype)[start:].view(*rows, cols)


def _under_no_grad(*tensors):
    with torch.no_grad():
        return needs_grad(*tensors)


def _weight():
    return torch.zeros(4, requires_grad=True)


CASES = {
    # mamba2-2.7b's layer: in_proj's bf16 rows of 10,576 columns, the
    # conv's first column 5,120 in
    "mamba2-2.7b": (lambda: aligned(_rows(10576), offset=5120 * 2), True),
    # the reduced models at heads of 64 (H 2): the conv's float32 rows of
    # 514 columns (2,056 bytes) and in_proj's bf16 rows of 290 (580 bytes)
    "heads of 64, conv rows": (
        lambda: aligned(_rows(514, dtype=torch.float32)), False),
    "heads of 64, in_proj rows": (lambda: aligned(_rows(290)), False),
    # ... which does not matter for a single row
    "a single row": (lambda: aligned(_rows(290, rows=(1, 1))), True),
    "a 16-byte offset": (lambda: aligned(_rows(10576), offset=16), True),
    "an 8-byte offset": (lambda: aligned(_rows(10576), offset=8), False),
    "a view 8 bytes in": (lambda: aligned(_rows(10576, start=4)), False),
    # the mapspace kernel's packed rows of 7 int32 (28 and 84 bytes): the
    # kernel asks only for the base pointer
    "int32 rows of 7": (
        lambda: aligned(torch.zeros(2, 3, 7, dtype=torch.int32)), False),
    "the base pointer only": (
        lambda: aligned(torch.zeros(2, 3, 7, dtype=torch.int32), dims=()),
        True),
    # a broadcast batch: a stride of 0 is not a positive multiple
    "a broadcast dim": (
        lambda: aligned(torch.zeros(1, 8, 4).expand(4, 8, 4)), False),
    "a weight under autograd": (
        lambda: needs_grad(torch.zeros(4), _weight()), True),
    "a weight under no_grad": (
        lambda: _under_no_grad(torch.zeros(4), _weight()), False),
    "no input needs a gradient": (
        lambda: needs_grad(torch.zeros(4), torch.zeros(4)), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_aligned_and_needs_grad(case):
    ask, want = CASES[case]
    assert ask() is want
