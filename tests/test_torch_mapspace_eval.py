"""Port's mapspace-scoring kernel module (repro_torch.kernels.mapspace_eval)
against the JAX package's Pallas kernels run in interpret mode.

On the CPU the port's wrappers compute the kernel's plain PyTorch version
(ref.py); the CUDA kernel itself is held against it on the card by
tests/test_torch_kernels_gpu.py (marked `gpu`) and by chip_smoke.py.
Tolerances, as for the Pallas kernel against its oracle: cycles rtol 1e-5,
energy rtol 1e-4 (float32 products of loop bounds pass 2**24, so the two
frameworks' rounding orders differ in the last bits)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import (MapperConfig, alexnet_cifar, analyze, build_mapspace,
                        make_fpga_arch, make_spatial_arch)
from repro.core.batch_eval import make_static, pack
from repro.kernels.mapspace_eval import ops as jax_ops
from repro_torch import convert
from repro_torch.kernels.mapspace_eval import kernel as tkernel
from repro_torch.kernels.mapspace_eval import ops as tops
from repro_torch.kernels.mapspace_eval import ref as tref

TW = analyze(alexnet_cifar(batch_size=4))
CYC_RTOL, EN_RTOL = 1e-5, 1e-4


def _arch(num_pes=64, rf_words=128, gbuf_words=16 * 1024):
    return make_spatial_arch(num_pes=num_pes, rf_words=rf_words,
                             gbuf_words=gbuf_words, bits=16, zero_skip=True)


def _packed(wi, hw, n=80, seed=2):
    """-> (JAX HwStatic, port HwStatic, factors, rank) of a no-bypass
    mapspace slice built by the JAX package's seeded mapper."""
    cfg = MapperConfig(max_mappings=400, seed=seed, enable_bypass=False)
    ms = build_mapspace(TW.intra[wi], hw, cfg).mappings[:n]
    assert ms, "empty mapspace would vacuously pass"
    st = make_static(hw, TW.intra[wi])
    factors, rank, _ = pack(ms)
    return (st, convert.static_from_dict(dataclasses.asdict(st)), factors,
            rank)


def _assert_close(port, jax_out):
    (ct, et), (cj, ej) = port, jax_out
    assert ct.shape == cj.shape and ct.dtype == np.float32
    np.testing.assert_allclose(ct, cj, rtol=CYC_RTOL)
    np.testing.assert_allclose(et, ej, rtol=EN_RTOL)


# the _mapspaces() cases of tests/test_kernels.py
@pytest.mark.parametrize("wi", [0, 2, 12, 28],
                         ids=lambda wi: TW.intra[wi].name)
def test_single_ref_matches_pallas(wi):
    st, st_t, factors, rank = _packed(wi, _arch())
    _assert_close(tops.mapspace_eval_arrays(st_t, factors, rank,
                                            device="cpu"),
                  jax_ops.mapspace_eval_arrays(st, factors, rank, block=64,
                                               interpret=True))


def test_single_ref_ragged_batch():
    st, st_t, factors, rank = _packed(2, _arch())
    factors, rank = factors[:37], rank[:37]          # not a block multiple
    out = tops.mapspace_eval_arrays(st_t, factors, rank, device="cpu")
    assert out[0].shape == (37,)
    _assert_close(out, jax_ops.mapspace_eval_arrays(
        st, factors, rank, block=32, interpret=True))


def test_single_ref_two_memory_levels():
    """make_fpga_arch: DDR3 -> BRAM -> Xbar -> PE (the kernel's N_MEM=2)."""
    hw = make_fpga_arch(name="fpga", num_pes=64, cache_kb=64)
    st, st_t, factors, rank = _packed(2, hw, n=64)
    assert len(st.mem_idx) == 2
    _assert_close(tops.mapspace_eval_arrays(st_t, factors, rank,
                                            device="cpu"),
                  jax_ops.mapspace_eval_arrays(st, factors, rank, block=64,
                                               interpret=True))


def _multi_groups():
    """Rows of two architectures and two workloads sharing a BatchSig."""
    small, big = _arch(), _arch(num_pes=256, rf_words=256,
                                gbuf_words=64 * 1024)
    parts = [_packed(2, small, n=40), _packed(2, big, n=30, seed=3),
             _packed(0, big, n=27)]
    return ([(st, f, r) for st, _, f, r in parts],
            [(st_t, f, r) for _, st_t, f, r in parts])


def test_multi_ref_matches_pallas():
    jax_groups, port_groups = _multi_groups()
    out = tops.mapspace_eval_multi(port_groups, device="cpu")
    assert out[0].shape == (97,)
    _assert_close(out, jax_ops.mapspace_eval_multi(jax_groups, block=32,
                                                   interpret=True))


def test_multi_ref_matches_single_rows():
    """The per-row variant agrees with the single-arch one row for row."""
    _, port_groups = _multi_groups()
    cm, em = tops.mapspace_eval_multi(port_groups, device="cpu")
    off = 0
    for st_t, f, r in port_groups:
        cs, es = tops.mapspace_eval_arrays(st_t, f, r, device="cpu")
        np.testing.assert_allclose(cm[off:off + len(f)], cs, rtol=CYC_RTOL)
        np.testing.assert_allclose(em[off:off + len(f)], es, rtol=EN_RTOL)
        off += len(f)


def test_multi_rejects_mixed_signatures():
    _, st_t, f, r = _packed(2, _arch(), n=8)
    _, st_p, fp, rp = _packed(1, _arch(), n=8)         # depthwise pooling
    with pytest.raises(ValueError, match="BatchSig"):
        tops.pack_for_kernel_multi([(st_t, f, r), (st_p, fp, rp)])


def _host_tensors(st_t, factors, rank):
    arrays, static, _ = tops.pack_for_kernel_arrays(st_t, factors, rank)
    return [torch.from_numpy(a) for a in arrays], static


def test_wrapper_checks_inputs():
    _, st_t, factors, rank = _packed(2, _arch(), n=16)
    tensors, static = _host_tensors(st_t, factors, rank)
    bad = list(tensors)
    bad[0] = bad[0].double()
    with pytest.raises(ValueError, match="float32"):
        tkernel.mapspace_eval_fwd(*bad, static=static)
    bad = list(tensors)
    bad[7] = bad[7].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.mapspace_eval_fwd(*bad, static=static)
    for i, cut in ((5, lambda t: t[:, :2]), (8, lambda t: t[:15]),
                   (7, lambda t: t[..., :20])):
        bad = list(tensors)
        bad[i] = cut(bad[i]).contiguous()
        with pytest.raises(ValueError, match=f"input {i} has shape"):
            tkernel.mapspace_eval_fwd(*bad, static=static)
    with pytest.raises(ValueError, match="memory levels"):
        tkernel.mapspace_eval_fwd(*tensors, static={**static, "n_mem": 4})
    _, port_groups = _multi_groups()
    fused, _ = tops.pack_for_kernel_multi(port_groups)
    fused = [torch.from_numpy(a) for a in fused]
    fused[14] = fused[14][:, :3].contiguous()
    with pytest.raises(ValueError, match="input 14 has shape"):
        tkernel.mapspace_eval_multi_fwd(*fused)


def test_cpu_tensors_use_ref_and_count_no_launch():
    _, st_t, factors, rank = _packed(2, _arch(), n=16)
    tensors, static = _host_tensors(st_t, factors, rank)
    before = dict(tkernel.LAUNCHES)
    c, e = tkernel.mapspace_eval_fwd(*tensors, static=static)
    cr, er = tref.score_ref(*tensors, static=static)
    assert torch.equal(c, cr) and torch.equal(e, er)
    assert tkernel.LAUNCHES == before


def test_hw_consts_layout():
    _, st_t, factors, rank = _packed(2, _arch(), n=4)
    _, static, _ = tops.pack_for_kernel_arrays(st_t, factors, rank)
    hc = tkernel.hw_consts(static)
    assert hc.shape == (6 * tkernel.MAX_MEM + 6,) and hc.dtype == np.float32
    zsf = hc[:9].reshape(3, 3)
    for j, zp in enumerate(static["zs_parent"]):
        expect = static["zf"] if zp else (1.0, 1.0, 1.0)
        np.testing.assert_array_equal(zsf[j], np.float32(expect))
    np.testing.assert_array_equal(hc[9:12], np.float32(static["mem_bw"]))
    np.testing.assert_allclose(
        hc[-3], np.float32(static["eff_macs"] * static["mac_energy"]))

