"""The port's CUDA mapspace-scoring kernels against their plain PyTorch
version (ref.py), on the card.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc, so every test here
is marked `gpu` and skips on a host without one.  The file imports nothing
of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances, as for the JAX package's kernel against its oracle: cycles
rtol 1e-5, energy rtol 1e-4 (products of loop bounds pass 2**24 in
float32, so reduction orders differ in the last bits)."""
import pytest
import torch

import repro_torch.core as tc
from repro_torch.kernels.mapspace_eval import kernel, ops, ref

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


def _packed(wi, hw, n=400):
    cfg = tc.MapperConfig(max_mappings=n, seed=1, enable_bypass=False)
    pm = tc.build_packed_mapspace(TW.intra[wi], hw, cfg)
    assert len(pm), "empty mapspace would vacuously pass"
    return pm


def _close(out, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], want[0], rtol=CYC_RTOL, atol=0)
    torch.testing.assert_close(out[1], want[1], rtol=EN_RTOL, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [_spatial(), tc.make_fpga_arch(
    name="fpga", num_pes=64, cache_kb=64)], ids=["3-levels", "2-levels"])
@pytest.mark.parametrize("rows", [None, 37], ids=["all", "ragged37"])
def test_single_kernel_matches_ref(card, hw, rows):
    pm = _packed(2, hw)
    arrays, static, _ = ops.pack_for_kernel_arrays(
        pm.static, pm.factors[:rows], pm.rank[:rows])
    t = [torch.from_numpy(a).to(card) for a in arrays]
    before = kernel.LAUNCHES["single"]
    _close(kernel.mapspace_eval_fwd(*t, static=static),
           ref.score_ref(*t, static=static))
    assert kernel.LAUNCHES["single"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [None, 37], ids=["all", "ragged37"])
def test_multi_kernel_matches_ref(card, rows):
    small, big = _spatial(), _spatial(256, 256, 64 * 1024)
    groups = [(p.static, p.factors[:rows], p.rank[:rows])
              for p in (_packed(2, small), _packed(2, big), _packed(0, big))]
    fused, _ = ops.pack_for_kernel_multi(groups)
    t = [torch.from_numpy(a).to(card) for a in fused]
    before = kernel.LAUNCHES["multi"]
    _close(kernel.mapspace_eval_multi_fwd(*t), ref.score_multi_ref(*t))
    assert kernel.LAUNCHES["multi"] == before + 1


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
