"""TRIM Designer: hardware template + architecture-space generation (paper §4).

A hardware description is a tree flattened into a list of *levels* ordered
outermost (off-chip DRAM) -> innermost (PE array).  Levels are:

  memory  — temporal staging (DRAM, global buffer, scratchpad/register file)
  routing — spatial fan-out (NoC): partitions work across parallel children
  compute — the PE array leaf (MACs)

This matches the paper's template (Table 1/2): e.g. Eyeriss is
[DRAM, Gbuf(108K), NoC(16x16), SP(520B), PE(168..256)].
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence, Tuple

from .workload import TENSORS


@dataclasses.dataclass(frozen=True)
class Level:
    kind: str                      # memory | routing | compute
    name: str
    # memory
    size_words: Optional[int] = None      # capacity (per instance); None = inf
    bandwidth: float = 1e30               # words/cycle through its interface
    usage: str = "shared"                 # shared | split
    split_sizes: Optional[Tuple[int, int, int]] = None  # (I, W, O) if split
    read_energy: float = 0.0              # pJ/word
    write_energy: float = 0.0             # pJ/word
    leak_power: float = 0.0               # pJ/cycle (per instance)
    area: float = 0.0                     # mm^2 (per instance)
    # routing
    fanout: int = 1                       # parallel children
    unicast_energy: float = 0.0           # pJ/word
    multicast_energy: float = 0.0         # pJ/word (single source copy)
    accum_energy: float = 0.0             # pJ/word (reduction traffic)
    # compute
    num_pes: int = 1
    macs_per_pe: int = 1                  # MACs/PE/cycle
    pipeline: int = 1                     # PE pipeline stages (paper §6.2)
    mac_energy: float = 0.0               # pJ/MAC
    pe_area: float = 0.0                  # mm^2/PE
    pe_leak: float = 0.0                  # pJ/cycle/PE

    def mem_capacity(self, tensor_idx: int) -> float:
        if self.size_words is None:
            return float("inf")
        if self.usage == "split" and self.split_sizes is not None:
            return self.split_sizes[tensor_idx]
        return self.size_words


@dataclasses.dataclass(frozen=True)
class HardwareDesc:
    """A specific hardware organization (one point in the arch space)."""

    name: str
    levels: Tuple[Level, ...]          # outermost -> innermost; last = compute
    precision_bits: int = 16
    frequency_hz: float = 200e6
    zero_skip_level: Optional[str] = None  # zero-skip circuits sit at this
    # level's downstream interface (paper: between Gbuf and RFs)

    def __post_init__(self):
        assert self.levels[-1].kind == "compute"
        assert self.levels[0].kind == "memory"
        for lv in self.levels[:-1]:
            assert lv.kind in ("memory", "routing")

    @property
    def tiling_levels(self) -> Tuple[Level, ...]:
        """All levels that receive loops (everything but the compute leaf)."""
        return self.levels[:-1]

    @property
    def compute(self) -> Level:
        return self.levels[-1]

    @property
    def bytes_per_word(self) -> float:
        return self.precision_bits / 8.0

    def memory_level_indices(self):
        return [i for i, lv in enumerate(self.tiling_levels)
                if lv.kind == "memory"]

    def routing_level_indices(self):
        return [i for i, lv in enumerate(self.tiling_levels)
                if lv.kind == "routing"]

    def instances(self, level_idx: int) -> int:
        """Parallel instances of tiling level `level_idx` (spatial fan-out of
        all routing levels strictly outer to it)."""
        inst = 1
        for lv in self.tiling_levels[:level_idx]:
            if lv.kind == "routing":
                inst *= lv.fanout
        return inst

    def total_pes(self) -> int:
        return self.compute.num_pes

    def total_area(self) -> float:
        area = self.compute.num_pes * self.compute.pe_area
        for i, lv in enumerate(self.tiling_levels):
            area += self.instances(i) * lv.area
        return area

    def zero_skip_boundary(self) -> Optional[int]:
        """Index of the tiling level at whose *downstream* interfaces the
        zero-skip discount applies (None = no zero-skip circuits)."""
        if self.zero_skip_level is None:
            return None
        for i, lv in enumerate(self.tiling_levels):
            if lv.name == self.zero_skip_level:
                return i
        raise ValueError(f"zero_skip_level {self.zero_skip_level!r} not found")


# ---------------------------------------------------------------------------
# 65nm-class energy/area tables (pluggable, Accelergy-style; paper §6.2).
# Values follow the widely used Eyeriss/Horowitz numbers (pJ @ 65nm, 16b):
#   MAC 16b ~0.8 pJ (we scale ~linearly with precision); RF access ~1 pJ;
#   NoC hop ~2 pJ; 100KB-class SRAM ~6 pJ; DRAM ~200 pJ/word.
# ---------------------------------------------------------------------------
ENERGY_65NM = {
    "mac_pj_per_bit": 0.05,           # MAC energy ≈ bits * this
    "rf_pj": 1.0,
    "sram_pj_per_sqrt_kb": 0.6,       # ≈ 0.6 * sqrt(KB) pJ/access
    "dram_pj": 200.0,
    "noc_unicast_pj": 2.0,
    "noc_multicast_pj": 1.0,
    "noc_accum_pj": 2.5,
    "sram_leak_pj_per_kb_per_cycle": 0.002,
    "rf_leak_pj_per_word_per_cycle": 0.0002,
}

AREA_65NM = {
    "pe_mm2_per_bit": 0.0004,         # MAC+control ≈ bits * this
    "sram_mm2_per_kb": 0.014,
    "rf_mm2_per_kb": 0.03,
    "noc_mm2_per_port": 0.002,
}


def _sram_read_pj(size_words: int, bits: int) -> float:
    kb = max(size_words * bits / 8.0 / 1024.0, 0.125)
    return ENERGY_65NM["sram_pj_per_sqrt_kb"] * math.sqrt(kb) * (bits / 16.0)


def make_spatial_arch(*, name: str = "spatial", num_pes: int = 256,
                      rf_words: int = 256, gbuf_words: int = 128 * 1024,
                      bits: int = 16, noc_shape: Optional[Tuple[int, int]] = None,
                      gbuf_bw: float = 16.0, dram_bw: float = 4.0,
                      rf_bw: float = 2.0, zero_skip: bool = False,
                      pipeline: int = 2, frequency_hz: float = 200e6
                      ) -> HardwareDesc:
    """Eyeriss-style spatial architecture (paper Table 2 / Fig 14).

    DRAM -> Gbuf -> NoC(num_pes) -> RF -> PE.
    """
    if noc_shape is None:
        side = int(math.isqrt(num_pes))
        noc_shape = (side, max(1, num_pes // side))
    rf_kb = rf_words * bits / 8.0 / 1024.0
    gbuf_kb = gbuf_words * bits / 8.0 / 1024.0
    levels = (
        Level(kind="memory", name="DRAM", size_words=None, bandwidth=dram_bw,
              read_energy=ENERGY_65NM["dram_pj"] * (bits / 16.0),
              write_energy=ENERGY_65NM["dram_pj"] * (bits / 16.0)),
        Level(kind="memory", name="Gbuf", size_words=gbuf_words,
              bandwidth=gbuf_bw,
              read_energy=_sram_read_pj(gbuf_words, bits),
              write_energy=_sram_read_pj(gbuf_words, bits),
              leak_power=ENERGY_65NM["sram_leak_pj_per_kb_per_cycle"] * gbuf_kb,
              area=AREA_65NM["sram_mm2_per_kb"] * gbuf_kb),
        Level(kind="routing", name="NoC", fanout=num_pes,
              bandwidth=2.0 * num_pes,
              unicast_energy=ENERGY_65NM["noc_unicast_pj"] * (bits / 16.0),
              multicast_energy=ENERGY_65NM["noc_multicast_pj"] * (bits / 16.0),
              accum_energy=ENERGY_65NM["noc_accum_pj"] * (bits / 16.0),
              area=AREA_65NM["noc_mm2_per_port"] * num_pes),
        Level(kind="memory", name="RF", size_words=rf_words, bandwidth=rf_bw,
              read_energy=ENERGY_65NM["rf_pj"] * (bits / 16.0),
              write_energy=ENERGY_65NM["rf_pj"] * (bits / 16.0),
              leak_power=ENERGY_65NM["rf_leak_pj_per_word_per_cycle"] * rf_words,
              area=AREA_65NM["rf_mm2_per_kb"] * rf_kb),
        Level(kind="compute", name="PE", num_pes=num_pes, macs_per_pe=1,
              pipeline=pipeline,
              mac_energy=ENERGY_65NM["mac_pj_per_bit"] * bits,
              pe_area=AREA_65NM["pe_mm2_per_bit"] * bits,
              pe_leak=0.001),
    )
    return HardwareDesc(name=name, levels=levels, precision_bits=bits,
                        frequency_hz=frequency_hz,
                        zero_skip_level="Gbuf" if zero_skip else None)


def make_fpga_arch(*, name: str, num_pes: int, cache_kb: float,
                   bits: int = 16, frequency_hz: float = 100e6,
                   dram_bw: float = 2.0) -> HardwareDesc:
    """PYNQ-Z1-class FPGA design (paper Fig 7 / Table 3):
    DDR3 -> BRAM cache -> PE array (DMA-fed, no per-PE RF level)."""
    cache_words = int(cache_kb * 1024 * 8 / bits)
    levels = (
        Level(kind="memory", name="DDR3", size_words=None, bandwidth=dram_bw,
              read_energy=ENERGY_65NM["dram_pj"] * (bits / 16.0) * 1.2,
              write_energy=ENERGY_65NM["dram_pj"] * (bits / 16.0) * 1.2),
        Level(kind="memory", name="BRAM", size_words=cache_words,
              bandwidth=float(2 * num_pes),
              read_energy=_sram_read_pj(cache_words, bits) * 2.0,
              write_energy=_sram_read_pj(cache_words, bits) * 2.0,
              leak_power=ENERGY_65NM["sram_leak_pj_per_kb_per_cycle"]
              * cache_kb * 4.0),
        Level(kind="routing", name="Xbar", fanout=num_pes,
              bandwidth=2.0 * num_pes,
              unicast_energy=1.0 * (bits / 16.0),
              multicast_energy=0.5 * (bits / 16.0),
              accum_energy=1.2 * (bits / 16.0)),
        Level(kind="compute", name="PE", num_pes=num_pes, macs_per_pe=1,
              pipeline=2, mac_energy=ENERGY_65NM["mac_pj_per_bit"] * bits * 3.0,
              pe_leak=0.005),
    )
    return HardwareDesc(name=name, levels=levels, precision_bits=bits,
                        frequency_hz=frequency_hz)


def generate_arch_space(*, num_pes: Sequence[int], rf_words: Sequence[int],
                        gbuf_words: Sequence[int], bits: int = 32,
                        zero_skip: bool = True, **kw):
    """TRIM Designer: cartesian product of architecture parameters
    (paper Table 1 / Algorithm 1 line 4)."""
    for npe, rf, gb in itertools.product(num_pes, rf_words, gbuf_words):
        yield make_spatial_arch(
            name=f"pe{npe}_rf{rf}_gb{gb}", num_pes=npe, rf_words=rf,
            gbuf_words=gb, bits=bits, zero_skip=zero_skip, **kw)
