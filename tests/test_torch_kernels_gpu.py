"""The port's CUDA mapspace-scoring kernels against their plain PyTorch
version (ref.py), on the card.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc, so every test here
is marked `gpu` and skips on a host without one.  The file imports nothing
of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances, as for the JAX package's kernel against its oracle: cycles
rtol 1e-5, energy rtol 1e-4 (products of loop bounds pass 2**24 in
float32, so reduction orders differ in the last bits); validity exactly
equal (integer products in double)."""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.backend import validity_mask_arrays
from repro_torch.kernels.mapspace_eval import kernel, ops, ref
from repro_torch.search import MapspaceJob, fused_best

CYC_RTOL, EN_RTOL = 1e-5, 1e-4
TW = tc.analyze(tc.alexnet_cifar(batch_size=4))


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    return torch.device("cuda", 0)


def _spatial(num_pes=64, rf_words=128, gbuf_words=16 * 1024):
    return tc.make_spatial_arch(name=f"pe{num_pes}", num_pes=num_pes,
                                rf_words=rf_words, gbuf_words=gbuf_words,
                                bits=16, zero_skip=True)


def _fpga(num_pes=64, cache_kb=64):
    return tc.make_fpga_arch(name=f"fpga{num_pes}", num_pes=num_pes,
                             cache_kb=cache_kb)


# (small architecture, large one) of each template: a large one's rows
# scored with a small one's record exceed its fan-out and buffers
TEMPLATES = {"3-levels": (_spatial, dict(num_pes=256, rf_words=256,
                                         gbuf_words=64 * 1024)),
             "2-levels": (_fpga, dict(num_pes=256, cache_kb=256))}


def _packed(wi, hw, n=400):
    cfg = tc.MapperConfig(max_mappings=n, seed=1, enable_bypass=False)
    pm = tc.build_packed_mapspace(TW.intra[wi], hw, cfg)
    assert len(pm), "empty mapspace would vacuously pass"
    return pm


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _close(out, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], want[0], rtol=CYC_RTOL, atol=0)
    torch.testing.assert_close(out[1], want[1], rtol=EN_RTOL, atol=0)
    assert torch.equal(out[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("template", sorted(TEMPLATES))
@pytest.mark.parametrize("rows", [None, 37], ids=["all", "ragged37"])
def test_single_kernel_matches_ref(card, template, rows):
    """Rows of a large architecture's mapspace scored as the small one:
    some are invalid, and `valid` equals the host check."""
    make, large = TEMPLATES[template]
    st = _packed(2, make()).static
    pm = _packed(2, make(**large))
    f, r, s = pm.factors[:rows], pm.rank[:rows], pm.store[:rows]
    t = _on(card, f, r, s, ops.job_record(st))
    layout = ops.layout_of(st)
    before = kernel.LAUNCHES["single"]
    out = kernel.mapspace_eval_fwd(*t, layout=layout)
    assert kernel.LAUNCHES["single"] == before + 1
    _close(out, ref.score_ref(*t, layout=layout))
    host = validity_mask_arrays(st, f, s)
    assert np.array_equal(out[2].cpu().numpy(), host)
    if rows is None:
        assert 0 < host.sum() < len(host), "needs valid and invalid rows"


def _multi(dev, template, rows):
    """Three jobs (two architectures, two workloads) -> kernel inputs;
    at 37 rows a job, the job boundaries fall inside the first block."""
    make, large = TEMPLATES[template]
    big2, big0 = _packed(2, make(**large)), _packed(0, make(**large))
    groups = [(st, p.factors[:rows], p.rank[:rows], p.store[:rows])
              for st, p in ((_packed(2, make()).static, big2),
                            (big2.static, big2), (big0.static, big0))]
    offsets = np.cumsum([0] + [len(g[1]) for g in groups]).astype(np.int32)
    t = _on(dev, *(np.concatenate([g[i] for g in groups]) for i in (1, 2, 3)),
            np.stack([ops.job_record(g[0]) for g in groups]), offsets)
    return t, groups, ops.layout_of(groups[0][0])


@pytest.mark.gpu
@pytest.mark.parametrize("template", sorted(TEMPLATES))
@pytest.mark.parametrize("rows", [None, 37], ids=["all", "ragged37"])
def test_multi_kernel_matches_ref(card, template, rows):
    t, groups, layout = _multi(card, template, rows)
    before = kernel.LAUNCHES["multi"]
    out = kernel.mapspace_eval_multi_fwd(*t, layout=layout)
    assert kernel.LAUNCHES["multi"] == before + 1
    _close(out, ref.score_multi_ref(*t, layout=layout))
    host = np.concatenate([validity_mask_arrays(st, f, s)
                           for st, f, _, s in groups])
    assert np.array_equal(out[2].cpu().numpy(), host)
    # each job's rows alone, as a single-job launch, give the same numbers
    lo = 0
    for st, f, r, s in groups:
        one = kernel.mapspace_eval_fwd(*_on(card, f, r, s,
                                            ops.job_record(st)),
                                       layout=layout)
        hi = lo + len(f)
        for a, b in zip(one, out):
            assert torch.equal(a, b[lo:hi])
        lo = hi


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(card):
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    pm = _packed(2, _fpga())                 # 84-byte rows
    f, r, s, job = _on(card, pm.factors, pm.rank, pm.store,
                       ops.job_record(pm.static))
    layout = ops.layout_of(pm.static)
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte boundary"):
        kernel.mapspace_eval_fwd(f[1:], r[1:], s[1:], job, layout=layout)
    with pytest.raises(ValueError, match="int32"):
        kernel.mapspace_eval_fwd(f.long(), r, s, job, layout=layout)
    assert kernel.LAUNCHES == before


@pytest.mark.gpu
def test_backend_engines_agree_on_card(card):
    """score_mapspace: the kernel engine and the oracle pick the same
    valid set and scores within the kernel tolerance."""
    pm = tc.build_packed_mapspace(TW.intra[2], _spatial(),
                                  tc.MapperConfig(max_mappings=600, seed=0))
    s_k, v_k = tc.score_mapspace(pm, backend="cuda", device=card)
    s_t, v_t = tc.score_mapspace(pm, backend="torch", device=card)
    assert (v_k == v_t).all()
    torch.testing.assert_close(torch.from_numpy(s_k), torch.from_numpy(s_t),
                               rtol=2e-4, atol=0)
    assert tc.best_index(pm, backend="cuda", device=card) == \
        tc.best_index(pm, backend="torch", device=card)


@pytest.mark.gpu
def test_fused_best_engines_agree_on_card(card):
    """fused_best: one multi launch per BatchSig group, the same winners
    as the oracle."""
    cfg = tc.MapperConfig(max_mappings=600, seed=0, enable_bypass=False)
    jobs = [MapspaceJob(tag=(hw.name, wi), hw=hw, workload=TW.intra[wi],
                        packed=tc.build_packed_mapspace(TW.intra[wi], hw, cfg))
            for hw in (_spatial(), _spatial(256, 256, 64 * 1024))
            for wi in (0, 2, 12)]
    before = kernel.LAUNCHES["multi"]
    out = fused_best(jobs, "edp", device=card, backend="cuda")
    assert kernel.LAUNCHES["multi"] > before
    want = fused_best(jobs, "edp", device=card, backend="torch")
    assert [(b.tag, b.index) for b in out] == [(b.tag, b.index) for b in want]
