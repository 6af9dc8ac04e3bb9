"""The port's CUDA flash-attention kernels against their plain PyTorch
version (ref.py), and the model's prefill through them, on the card: the
tensor-core kernel (route "wgmma": bf16 at D 64 and 128, aligned) and the
SIMT kernel (everything else), as `kernel.choose_route` picks.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc, so every test here
is marked `gpu` and skips on a host without one.  The file imports nothing
of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_gpu.py

Tolerances, as for the JAX package's kernel against its oracle
(tests/test_kernels.py): 2e-5 in float32 (sums in another order), 2e-2 in
bfloat16 (both outputs rounded to bf16, one unit in the last place apart
at most)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.models import attention, forward, init_model

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's
    return torch.device("cuda", 0)                  # products in full fp32


def _qkv(b, s, h, hkv, d, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(dev, dtype) for shape in ((b, s, h, d), (b, s, hkv, d),
                                          (b, s, hkv, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,hkv,d,dtype", [
    (2, 256, 4, 2, 64, torch.bfloat16), (1, 128, 8, 8, 128, torch.float32),
    (1, 1000, 8, 8, 128, torch.float32), (2, 77, 9, 3, 64, torch.bfloat16),
    (1, 300, 4, 2, 80, torch.bfloat16), (2, 129, 6, 2, 96, torch.float32),
    (1, 1, 2, 1, 64, torch.float32), (4, 2048, 9, 3, 64, torch.bfloat16),
    (2, 256, 4, 2, 128, torch.bfloat16), (1, 1000, 8, 2, 128, torch.bfloat16),
    (1, 1000, 6, 2, 64, torch.bfloat16), (1, 1, 2, 1, 128, torch.bfloat16),
], ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_kernel_matches_ref(card, b, s, h, hkv, d, dtype, causal):
    q, k, v = _qkv(b, s, h, hkv, d, dtype, card)
    tc = dtype == torch.bfloat16 and d in (64, 128)
    assert kernel.choose_route(q, k, v) == ("wgmma" if tc else "simt")
    before = dict(kernel.LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["flash"] == before["flash"] + 1
    assert kernel.LAUNCHES["flash_wgmma"] == before["flash_wgmma"] + tc
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
def test_kernel_reads_strided_kv(card):
    """k/v as views into one packed [B,S,2*Hkv,D] tensor: the kernel reads
    them with their strides, no copy."""
    q, kv, _ = _qkv(2, 200, 6, 4, 64, torch.float32, card)
    k, v = kv[:, :, :2], kv[:, :, 2:]
    assert not k.is_contiguous()
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_reads_strided_kv_bf16(card, d):
    """The same in bf16 on the tensor-core route: the tensor maps take the
    views' strides, so K/V are read in place, with no copy."""
    q, kv, _ = _qkv(2, 200, 6, 4, d, torch.bfloat16, card)
    k, v = kv[:, :, :2], kv[:, :, 2:]
    assert not k.is_contiguous() and kernel.choose_route(q, k, v) == "wgmma"
    before = kernel.LAUNCHES["flash_wgmma"]
    out = ops.flash_attention(q, k, v)
    assert kernel.LAUNCHES["flash_wgmma"] == before + 1
    torch.testing.assert_close(out.float(),
                               ref.flash_attention_ref(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_tensor_core_route_ignores_strides_of_extent_one(card):
    """A [1, S, H, D] view whose batch stride is 1 element is as good as
    contiguous: it stays on the tensor-core route, whose tensor map takes a
    packed stride for a dimension read only at coordinate 0."""
    q, k, v = _qkv(1, 150, 6, 2, 64, torch.bfloat16, card)
    qs, ks, vs = (t.as_strided(t.shape, (1,) + t.stride()[1:])
                  for t in (q, k, v))
    assert qs.stride(0) == 1 and kernel.choose_route(qs, ks, vs) == "wgmma"
    before = kernel.LAUNCHES["flash_wgmma"]
    out = ops.flash_attention(qs, ks, vs)
    assert kernel.LAUNCHES["flash_wgmma"] == before + 1
    torch.testing.assert_close(out.float(),
                               ref.flash_attention_ref(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_misaligned_bf16_takes_the_simt_kernel(card):
    """bf16 at D=64 whose head stride is not a multiple of 16 bytes (a
    padded layout) goes to the SIMT kernel and agrees all the same."""
    q, k, v = _qkv(1, 130, 4, 2, 64, torch.bfloat16, card)
    pad = [torch.zeros(*t.shape[:3], 65, dtype=t.dtype, device=card)
           for t in (q, k, v)]
    for t, p in zip((q, k, v), pad):
        p[..., :64] = t
    qp, kp, vp = (p[..., :64] for p in pad)
    assert kernel.choose_route(qp, kp, vp) == "simt"
    before = dict(kernel.LAUNCHES)
    out = ops.flash_attention(qp, kp, vp)
    assert kernel.LAUNCHES["flash"] == before["flash"] + 1
    assert kernel.LAUNCHES["flash_wgmma"] == before["flash_wgmma"]
    torch.testing.assert_close(out.float(),
                               ref.flash_attention_ref(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _qkv(1, 64, 2, 1, 64, torch.float16, card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 64, 2, 1, 64, torch.float32, card)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)


@pytest.mark.gpu
def test_model_prefill_through_the_kernel(card):
    """forward(logits_mode="last") with the kernel installed launches it
    once a layer and equals the plain-attention forward (float32; the
    reduced config with head_dim 64, a width the kernel takes)."""
    cfg = dataclasses.replace(reduced_config("smollm-135m"), head_dim=64)
    model = init_model(cfg, torch.Generator().manual_seed(0), device=card)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (3, 150))).to(card)
    with torch.no_grad():
        plain = forward(model, cfg, {"tokens": tokens}, logits_mode="last")
        ops.install()
        try:
            before = kernel.LAUNCHES["flash"]
            fused = forward(model, cfg, {"tokens": tokens},
                            logits_mode="last")
            torch.cuda.synchronize()
            assert kernel.LAUNCHES["flash"] == before + cfg.n_layers
        finally:
            attention.set_flash_impl(None)
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_smollm_shaped_bf16_prefill_takes_the_tensor_core_route(card):
    """smollm-135m's attention shape (9 query on 3 KV heads of 64) in bf16,
    through the model's own projections: every layer's launch is on the
    tensor-core route, and the logits stay near plain attention's."""
    cfg = dataclasses.replace(reduced_config("smollm-135m"), n_heads=9,
                              n_kv_heads=3, head_dim=64,
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = init_model(cfg, torch.Generator().manual_seed(0), device=card)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 300))).to(card)
    with torch.no_grad():
        plain = forward(model, cfg, {"tokens": tokens}, logits_mode="last")
        ops.install()
        try:
            before = dict(kernel.LAUNCHES)
            fused = forward(model, cfg, {"tokens": tokens},
                            logits_mode="last")
            torch.cuda.synchronize()
        finally:
            attention.set_flash_impl(None)
    assert kernel.LAUNCHES["flash"] == before["flash"] + cfg.n_layers
    assert kernel.LAUNCHES["flash_wgmma"] == \
        before["flash_wgmma"] + cfg.n_layers
    # bf16 forwards that round at different points: 5% of the logits'
    # range, as chip_smoke.py's LOGIT_TOL for the full-size prefill
    err = (fused.float() - plain.float()).abs().max().item()
    assert err <= 5e-2 * plain.float().abs().max().item()


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(card):
    """ServeEngine on the card and on the CPU, same float32 params and
    requests -> the same tokens for every request."""
    from repro_torch.serve import Request, ServeEngine
    cfg = reduced_config("smollm-135m")
    host = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = init_model(cfg, torch.Generator().manual_seed(0), device=card)
    model.load_state_dict(host.state_dict())
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(1, 9, 5)]
    out = []
    for m, dev in ((host, "cpu"), (model, card)):
        eng = ServeEngine(cfg, m, batch=2, max_len=24, device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
        eng.run_until_drained()
        out.append({rid: r.out_tokens for rid, r in eng.done.items()})
    assert out[0] == out[1] and len(out[0]) == len(prompts)
