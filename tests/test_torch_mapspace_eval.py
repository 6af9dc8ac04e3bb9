"""Port's mapspace-scoring kernel module (repro_torch.kernels.mapspace_eval)
against the JAX package: its host packer (`ops._mapping_rows`,
`ops._hw_numerics`), its Pallas kernels run in interpret mode, and its host
validity check (`core.backend.validity_mask_arrays`).

On the CPU the port's wrappers compute the kernel's plain PyTorch version
(ref.py), which derives every per-row quantity from the packed mapspace as
the CUDA kernel does; the CUDA kernel itself is held against it on the card
by tests/test_torch_kernels_gpu.py (marked `gpu`) and by chip_smoke.py.
Tolerances: the derived rows equal the packer's exactly (same float32
operations in the same order); scores as for the Pallas kernel against its
oracle, cycles rtol 1e-5 and energy rtol 1e-4 (the score body's products
pass 2**24 in float32 and the two frameworks reduce in other orders);
validity exactly equal (integer products in float64)."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import (MapperConfig, alexnet_cifar, analyze, build_mapspace,
                        make_fpga_arch, make_spatial_arch)
from repro.core.backend import validity_mask_arrays
from repro.core.batch_eval import make_static, pack
from repro.kernels.mapspace_eval import ops as jax_ops
from repro_torch import convert
from repro_torch.kernels.mapspace_eval import kernel as tkernel
from repro_torch.kernels.mapspace_eval import ops as tops
from repro_torch.kernels.mapspace_eval import ref as tref

TW = analyze(alexnet_cifar(batch_size=4))
CYC_RTOL, EN_RTOL = 1e-5, 1e-4


def _arch(num_pes=64, rf_words=128, gbuf_words=16 * 1024, zero_skip=True):
    return make_spatial_arch(num_pes=num_pes, rf_words=rf_words,
                             gbuf_words=gbuf_words, bits=16,
                             zero_skip=zero_skip)


def _fpga(num_pes=64, cache_kb=64):
    """make_fpga_arch: DDR3 -> BRAM -> Xbar -> PE (the kernel's N_MEM=2)."""
    return make_fpga_arch(name="fpga", num_pes=num_pes, cache_kb=cache_kb)


# (small architecture, large one) of each template
TEMPLATES = {"3-levels": (_arch, dict(num_pes=256, rf_words=256,
                                      gbuf_words=64 * 1024)),
             "2-levels": (_fpga, dict(num_pes=256, cache_kb=256))}


def _packed(wi, hw, n=80, seed=2):
    """-> (JAX HwStatic, port HwStatic, factors, rank, store) of a
    no-bypass mapspace slice built by the JAX package's seeded mapper."""
    cfg = MapperConfig(max_mappings=400, seed=seed, enable_bypass=False)
    ms = build_mapspace(TW.intra[wi], hw, cfg).mappings[:n]
    assert ms, "empty mapspace would vacuously pass"
    st = make_static(hw, TW.intra[wi])
    factors, rank, store = pack(ms)
    return (st, convert.static_from_dict(dataclasses.asdict(st)), factors,
            rank, store)


def _assert_close(port, jax_out):
    (ct, et, _), (cj, ej) = port, jax_out
    assert ct.shape == cj.shape and ct.dtype == np.float32
    np.testing.assert_allclose(ct, cj, rtol=CYC_RTOL)
    np.testing.assert_allclose(et, ej, rtol=EN_RTOL)


# the _mapspaces() cases of tests/test_kernels.py, a ragged slice (not a
# block multiple) and the two-memory-level template
SINGLE = [("3-levels", 0, None), ("3-levels", 2, None),
          ("3-levels", 12, None), ("3-levels", 28, None),
          ("3-levels", 2, 37), ("2-levels", 2, 64)]


@pytest.mark.parametrize("template,wi,rows", SINGLE,
                         ids=[f"{t}-{TW.intra[wi].name}-{r or 'all'}"
                              for t, wi, r in SINGLE])
def test_single_ref_matches_pallas(template, wi, rows):
    st, st_t, factors, rank, store = _packed(wi, TEMPLATES[template][0]())
    factors, rank, store = factors[:rows], rank[:rows], store[:rows]
    out = tops.mapspace_eval_arrays(st_t, factors, rank, store, device="cpu")
    assert out[0].shape == (factors.shape[0],)
    _assert_close(out, jax_ops.mapspace_eval_arrays(
        st, factors, rank, block=32, interpret=True))
    np.testing.assert_array_equal(out[2],
                                  validity_mask_arrays(st, factors, store))


@pytest.mark.parametrize("template", sorted(TEMPLATES))
@pytest.mark.parametrize("wi", [0, 1, 2, 12, 28],
                         ids=lambda wi: TW.intra[wi].name)
def test_derive_rows_matches_packer(template, wi):
    """Both templates; intra[1] is a depthwise pooling layer."""
    st, st_t, factors, rank, _ = _packed(wi, TEMPLATES[template][0]())
    want, *_ = jax_ops._mapping_rows(st, factors, rank)
    rec = tref.row_records(torch.from_numpy(tops.job_record(st_t)), None,
                           factors.shape[0])
    got = tref.derive_rows(torch.from_numpy(factors), torch.from_numpy(rank),
                           rec, tops.layout_of(st_t))
    assert len(got) == len(want) == 12
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32, i
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=i)


RECORDS = [("3-levels", 2, True), ("3-levels", 2, False),
           ("3-levels", 1, True), ("2-levels", 2, False)]


@pytest.mark.parametrize("template,wi,zero_skip", RECORDS,
                         ids=[f"{t}-{TW.intra[wi].name}-zs{int(z)}"
                              for t, wi, z in RECORDS])
def test_job_record_matches_hw_numerics(template, wi, zero_skip):
    make = TEMPLATES[template][0]
    hw = make(zero_skip=zero_skip) if template == "3-levels" else make()
    st, st_t, *_ = _packed(wi, hw, n=4)
    rec = tops.job_record(st_t)
    get = lambda name: rec[slice(tref.REC_OFFSETS[name][0],
                                 sum(tref.REC_OFFSETS[name]))]
    hwn = jax_ops._hw_numerics(st)
    n_mem, n_rout = len(st.mem_idx), len(st.rout_idx)
    for name, key in (("mem_bw", "mem_bw"), ("e_read", "e_read"),
                      ("e_write", "e_write"), ("zf", "zf")):
        np.testing.assert_array_equal(get(name)[:len(hwn[key])], hwn[key])
    for name, key in (("macs", "macs"), ("eff_macs", "eff_macs"),
                      ("macs_per_pe", "macs_per_pe"),
                      ("pipeline", "pipeline"), ("mac_energy", "mac_energy"),
                      ("leak", "leak_rate"), ("noc_bw", "noc_bw")):
        assert get(name)[0] == hwn[key], name
    np.testing.assert_array_equal(get("sizes")[:n_mem], st.sizes)
    for name in ("fanout", "uni_e", "multi_e", "acc_e"):
        np.testing.assert_array_equal(get(name)[:n_rout], getattr(st, name))
        assert not get(name)[n_rout:].any()
    assert get("zs_boundary")[0] == st.zs_boundary
    np.testing.assert_array_equal(get("stride"), st.stride)
    np.testing.assert_array_equal(get("dilation"), st.dilation)
    assert tops.layout_of(st_t) == (st.n_levels, st.mem_idx, st.rout_idx,
                                    st.depthwise, st.has_weight)


@pytest.mark.parametrize("template", sorted(TEMPLATES))
def test_valid_matches_jax_validity(template):
    """A large architecture's rows scored as the small one: some exceed
    its fan-out or buffers.  Scores still match the Pallas kernel's."""
    make, large = TEMPLATES[template]
    st, st_t, *_ = _packed(2, make(), n=4)
    _, _, factors, rank, store = _packed(2, make(**large), n=200)
    out = tops.mapspace_eval_arrays(st_t, factors, rank, store, device="cpu")
    want = validity_mask_arrays(st, factors, store)
    assert 0 < want.sum() < len(want), "needs valid and invalid rows"
    np.testing.assert_array_equal(out[2], want)
    _assert_close(out, jax_ops.mapspace_eval_arrays(
        st, factors, rank, block=64, interpret=True))


def _multi_groups():
    """Rows of two architectures and two workloads sharing a BatchSig."""
    small, big = _arch(), _arch(num_pes=256, rf_words=256,
                                gbuf_words=64 * 1024)
    parts = [_packed(2, small, n=40), _packed(2, big, n=30, seed=3),
             _packed(0, big, n=27)]
    return ([(st, f, r) for st, _, f, r, _ in parts],
            [(st_t, f, r, s) for _, st_t, f, r, s in parts], parts)


def test_multi_ref_matches_pallas():
    jax_groups, port_groups, parts = _multi_groups()
    out = tops.mapspace_eval_multi(port_groups, device="cpu")
    assert out[0].shape == (97,)
    _assert_close(out, jax_ops.mapspace_eval_multi(jax_groups, block=32,
                                                   interpret=True))
    np.testing.assert_array_equal(out[2], np.concatenate(
        [validity_mask_arrays(st, f, s) for st, _, f, _, s in parts]))


def test_multi_ref_matches_single_rows():
    """The multi-job launch is the single-job one row for row."""
    _, port_groups, _ = _multi_groups()
    multi = tops.mapspace_eval_multi(port_groups, device="cpu")
    off = 0
    for st_t, f, r, s in port_groups:
        single = tops.mapspace_eval_arrays(st_t, f, r, s, device="cpu")
        for m, o in zip(multi, single):
            np.testing.assert_array_equal(m[off:off + len(f)], o)
        off += len(f)


def test_multi_rejects_mixed_signatures():
    _, st_t, f, r, s = _packed(2, _arch(), n=8)
    _, st_p, fp, rp, sp = _packed(1, _arch(), n=8)       # depthwise pooling
    with pytest.raises(ValueError, match="BatchSig"):
        tops.mapspace_eval_multi([(st_t, f, r, s), (st_p, fp, rp, sp)],
                                 device="cpu")


def _host_tensors(st_t, factors, rank, store):
    return [torch.from_numpy(a) for a in (factors, rank, store,
                                          tops.job_record(st_t))]


def test_wrapper_checks_inputs():
    _, st_t, factors, rank, store = _packed(2, _arch(), n=16)
    layout = tops.layout_of(st_t)
    tensors = _host_tensors(st_t, factors, rank, store)
    fwd = lambda t, **kw: tkernel.mapspace_eval_fwd(
        *t, layout=kw.get("layout", layout))
    for i, bad, match in (
            (0, tensors[0].float(), "factors must be a contiguous "
                                    "torch.int32"),
            (2, tensors[2].to(torch.uint8), "store must be a contiguous "
                                            "torch.bool"),
            (3, tensors[3].float(), "jobs must be a contiguous "
                                    "torch.float64"),
            (1, tensors[1].transpose(1, 2).contiguous().transpose(1, 2),
             "rank must be a contiguous"),
            (1, tensors[1][:15], r"rank has shape \(15, 4, 7\)"),
            (2, tensors[2][:, :2].contiguous(), r"store has shape"),
            (3, tensors[3][:40], r"jobs has shape \(40,\)")):
        t = list(tensors)
        t[i] = bad
        with pytest.raises(ValueError, match=match):
            fwd(t)
    with pytest.raises(ValueError, match="memory levels"):
        fwd(tensors, layout=layout._replace(mem_idx=(0, 1, 2, 3)))
    with pytest.raises(ValueError, match="routing levels"):
        fwd(tensors, layout=layout._replace(rout_idx=()))
    with pytest.raises(ValueError, match="one job record"):
        tkernel.mapspace_eval_fwd(*tensors[:3], tensors[3][None],
                                  layout=layout)
    jobs = tensors[3][None].repeat(2, 1)
    with pytest.raises(ValueError, match=r"offsets has shape \(2,\)"):
        tkernel.mapspace_eval_multi_fwd(
            *tensors[:3], jobs, torch.tensor([0, 16], dtype=torch.int32),
            layout=layout)


def test_cpu_tensors_use_ref_and_count_no_launch():
    _, st_t, factors, rank, store = _packed(2, _arch(), n=16)
    layout = tops.layout_of(st_t)
    tensors = _host_tensors(st_t, factors, rank, store)
    before = dict(tkernel.LAUNCHES)
    out = tkernel.mapspace_eval_fwd(*tensors, layout=layout)
    want = tref.score_ref(*tensors, layout=layout)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    offsets = torch.tensor([0, 16], dtype=torch.int32)
    out = tkernel.mapspace_eval_multi_fwd(*tensors[:3], tensors[3][None],
                                          offsets, layout=layout)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert tkernel.LAUNCHES == before


def test_job_record_layout():
    """`ref.REC_FIELDS` is the CUDA `JobRec` field for field (the card
    checks the compiled offsets again when it binds the library), and
    `job_record` puts each value at its field's offset."""
    src = Path(tkernel.LIBRARY.source).read_text()
    body = re.search(r"struct JobRec \{(.*?)\};", src, re.S).group(1)
    consts = {"kMaxMem": tref.MAX_MEM, "kMaxRout": tref.MAX_ROUT}
    fields = []
    for line in body.splitlines():
        m = re.match(r"\s*double ([\w, ]+?)(?:\[(\w+)\])?;", line)
        if m:
            n = m.group(2)
            n = 1 if n is None else consts.get(n) or int(n)
            fields += [(name.strip(), n) for name in m.group(1).split(",")]
    assert tuple(fields) == tref.REC_FIELDS
    assert tref.REC_DOUBLES * 8 % 16 == 0        # staged 16 bytes a copy
    _, st_t, *_ = _packed(2, _arch(), n=4)
    rec = tops.job_record(st_t)
    assert rec.shape == (tref.REC_DOUBLES,) and rec.dtype == np.float64
    o, n = tref.REC_OFFSETS["sizes"]
    np.testing.assert_array_equal(rec[o:o + n], st_t.sizes)
    assert np.isinf(rec[o])                      # DRAM is unbounded
    o, _ = tref.REC_OFFSETS["pad"]
    assert o == tref.REC_DOUBLES - 1 and rec[o] == 0.0
