"""Brute-force mapping simulator — the oracle for the analytical evaluator.

Literally iterates a mapping's flattened temporal loops and counts words
moved across every storage-chain interface under single-resident-tile buffer
semantics (each level's buffer holds exactly the current child tile of each
tensor; a delta fetch loads only words not already resident).

Footprints are axis-aligned dense boxes: per-axis [start, start+extent)
intervals (matching the analytical model's dense-extent tiles — real DMA
fetches contiguous ranges).  This gives the simulator *more* reuse than the
closed form at wrap-around boundaries of sliding loops, so the contract is:

    analytical == simulated            for workloads with R == S == 1
    analytical >= simulated            in general (certified upper bound)

which the hypothesis property tests assert.  Only usable for tiny bounds.

A framework-free copy of the JAX package's `core/simulator.py`: the port
imports nothing of that package, so it keeps its own.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Tuple

from .evaluator import COMPUTE, storage_chain
from .mapping import Mapping
from .workload import Workload, N_, M_, C_, R_, S_, E_, F_


def _flat_loops(mapping: Mapping, below_level: int):
    """[(dim, bound, stride_in_dim)] outer->inner for memory levels strictly
    outer than `below_level`; stride_in_dim = product of inner splits of the
    same dim (how far one iteration advances the tile start)."""
    stop = below_level if below_level != COMPUTE else len(mapping.factors)
    loops = []
    for li in range(stop):
        lv = mapping.hardware.tiling_levels[li]
        if lv.kind != "memory":
            continue
        order = mapping.orders[li] or tuple(range(7))
        for pos, d in enumerate(order):
            b = mapping.factors[li][d]
            if b > 1:
                loops.append((li, pos, d, b))
    out = []
    for (li, pos, d, b) in loops:
        stride = 1
        # inner splits of dim d: later levels entirely, and (within the same
        # level) loops after `pos` cannot be the same dim (each dim appears
        # once per level), so: levels > li only...
        for lj in range(li + 1, len(mapping.factors)):
            stride *= mapping.factors[lj][d]
        out.append((d, b, stride))
    return out


def _box(wl: Workload, tensor: str, start: Tuple[int, ...],
         tile: Tuple[int, ...]):
    """Axis-aligned footprint box [(lo, hi)...] of the child tile whose
    per-dim start indices are `start` and extents `tile`."""
    n0, m0, c0, r0, s0, e0, f0 = start
    nt, mt, ct, rt, st, et, ft = tile
    u, v = wl.stride
    dr, ds = wl.dilation
    if tensor == "weight":
        return ((r0, r0 + rt), (s0, s0 + st), (c0, c0 + ct), (m0, m0 + mt))
    if tensor == "output":
        last = (c0, c0 + ct) if wl.depthwise else (m0, m0 + mt)
        return ((n0, n0 + nt), (e0, e0 + et), (f0, f0 + ft), last)
    p0 = e0 * u + r0 * dr
    q0 = f0 * v + s0 * ds
    pe = wl.input_extent(et, rt, 0)
    qe = wl.input_extent(ft, st, 1)
    return ((n0, n0 + nt), (p0, p0 + pe), (q0, q0 + qe), (c0, c0 + ct))


def _vol(box) -> int:
    return math.prod(max(0, hi - lo) for lo, hi in box)


def _inter(a, b):
    return tuple((max(al, bl), min(ah, bh)) for (al, ah), (bl, bh)
                 in zip(a, b))


def simulate_pair(mapping: Mapping, tensor: str, child: int
                  ) -> Dict[str, float]:
    """Simulate the interface delivering child-level tiles of `tensor`.

    Returns dict with down_words / up_words (matching evaluator semantics).
    """
    wl = mapping.workload
    tile = ((1,) * 7 if child == COMPUTE else mapping.tile_dims(child))
    loops = _flat_loops(mapping, child)
    rel = wl.relevance(tensor)

    if not loops:
        if tensor == "output":
            return {"down_words": 0.0,
                    "up_words": float(wl.tile_words(tensor, tile))}
        return {"down_words": float(wl.tile_words(tensor, tile)),
                "up_words": 0.0}

    ranges = [range(b) for (_, b, _) in loops]
    down = up = 0.0
    prev_box = None
    prev_tile_id = None
    seen = set()
    tile_words = wl.tile_words(tensor, tile)
    for idxs in itertools.product(*ranges):
        # stride is already in element units (product of inner splits), so
        # the tile start per dim is just the weighted sum of loop indices.
        start = [0] * 7
        for (d, _, stride), i in zip(loops, idxs):
            start[d] += i * stride
        if tensor == "output":
            tid = tuple(start[d] for d in range(7) if rel[d])
            if tid != prev_tile_id:
                if prev_tile_id is not None:
                    up += tile_words          # flush previous tile upward
                if tid in seen:
                    down += tile_words        # psum read-back
                seen.add(tid)
                prev_tile_id = tid
        else:
            box = _box(wl, tensor, tuple(start), tile)
            if prev_box is None:
                down += _vol(box)
            else:
                down += _vol(box) - _vol(_inter(box, prev_box))
            prev_box = box
    if tensor == "output":
        up += tile_words                       # final flush
    return {"down_words": down, "up_words": up}


def simulate_activity(mapping: Mapping) -> Dict[Tuple[str, int], Dict]:
    """All chain pairs: {(tensor, child_level): {down_words, up_words}}."""
    out = {}
    tensors = ["input", "output"] + (
        ["weight"] if mapping.workload.has_weight else [])
    for tensor in tensors:
        chain = storage_chain(mapping, tensor)
        for child in chain[1:] + [COMPUTE]:
            out[(tensor, child)] = simulate_pair(mapping, tensor, child)
    return out
