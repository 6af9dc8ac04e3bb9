"""The `moe`, `vlm` and `encdec` families, MLA and the two dense
configurations of chip_smoke.py's phase 13 on the card, at the reduced
configs of granite-moe-1b-a400m, qwen2-vl-2b, whisper-small, minicpm3-4b
and deepseek-v2-lite-16b (2 layers, d_model 64) with head dim 64, and of
phi3-mini-3.8b and nemotron-4-15b at their own head dims, 96 and 128
(widths the flash kernels take):

  * in bf16 with the flash hook installed, the prefill launches the flash
    kernel once per causal self-attention of equal head dims (2, 2, 2 for
    whisper's decoder, 0 for MLA, 2 for phi3 and nemotron), all on the
    tensor-core route (phi3's D 96 too, padded to two panels), and nothing
    else;
  * in float32 (the SIMT route) the flash prefill equals the plain-
    attention prefill at 1e-4 (the kernel's float32 tolerance, 2e-5 a
    layer, through 2 blocks and the head), and teacher-forced decode
    equals the prefill (MoE at a capacity factor of E/k, where no token is
    dropped at either token count; whisper's decode is not its forward's
    decoder, as in the reference; nemotron's squared-ReLU MLP and untied
    head too);
  * qwen2-vl's prefill from `embeds` and `positions3` of a patch grid
    (text, an image, text; M-RoPE's three sections differ) launches the
    kernel once a layer on the route of its dtype, and in float32 equals
    the plain-attention prefill at 1e-4;
  * the engine answers requests for each family.

Needs an NVIDIA GPU of compute capability 9.0 and nvcc; every test is
marked `gpu` and skips without one.  Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_families_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.models import (attention, decode_step, forward, init_cache,
                                init_model)
from repro_torch.serve import Request, ServeEngine

# flash launches per prefill at the reduced depth, all on the tensor-core
# route in bf16
FLASH_CALLS = {"granite-moe-1b-a400m": 2, "qwen2-vl-2b": 2,
               "whisper-small": 2, "minicpm3-4b": 0,
               "deepseek-v2-lite-16b": 0, "phi3-mini-3.8b": 2,
               "nemotron-4-15b": 2}
# the registered head dim where the kernels take it; 64 elsewhere
HEAD_DIM = {"phi3-mini-3.8b": 96, "nemotron-4-15b": 128}
TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's
    return torch.device("cuda", 0)                  # products in full fp32


def _cfg(arch, dtype="float32", **changes):
    cfg = reduced_config(arch)
    if cfg.rope == "mrope":
        changes["mrope_sections"] = (8, 12, 12)     # 32 pairs at D 64
    return dataclasses.replace(cfg, head_dim=HEAD_DIM.get(arch, 64),
                               param_dtype=dtype, compute_dtype=dtype,
                               **changes)


def _batch(cfg, dev, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                        ).to(dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model), np.float32)).to(dev)
    return batch


def _patch_grid_batch(cfg, dev, b=2, before=8, grid=(4, 6), after=20,
                      seed=4):
    """embeds [B, S, d] (normal, std 0.02) and positions3 [3, B, S] as
    Qwen2-VL numbers text, an image of `grid` patches and text: text at
    (i, i, i); a patch at (L, L + row, L + col) after L text tokens; text
    after the image from one past the largest position before it."""
    gh, gw = grid
    rows, cols = np.divmod(np.arange(gh * gw), gw)
    img = before + np.stack([0 * rows, rows, cols])
    pos = np.concatenate([np.tile(np.arange(before), (3, 1)), img,
                          np.tile(img.max() + 1 + np.arange(after), (3, 1))],
                         axis=1)
    s = pos.shape[1]
    embeds = 0.02 * np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model), np.float32)
    return {"embeds": torch.from_numpy(embeds).to(dev),
            "positions3": torch.from_numpy(pos).to(dev)[:, None].expand(
                3, b, s)}


def _prefill(model, cfg, batch, flash: bool):
    with torch.no_grad():
        if flash:
            ops.install()
        try:
            return forward(model, cfg, batch)
        finally:
            attention.set_flash_impl(None)


def _bf16_prefill_launches(card, arch):
    """-> the flash launches of a bf16 prefill with the hook installed,
    and of them those on the tensor-core route."""
    cfg = _cfg(arch, "bfloat16")
    model = init_model(cfg, torch.Generator(card).manual_seed(0),
                       device=card)
    kernel.reset_launches()
    logits = _prefill(model, cfg, _batch(cfg, card), flash=True)
    torch.cuda.synchronize()
    assert logits.shape == (2, 64, cfg.vocab)
    assert torch.isfinite(logits).all()
    return kernel.LAUNCHES["flash"], kernel.LAUNCHES["flash_wgmma"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(FLASH_CALLS))
def test_bf16_prefill_launches_the_tensor_core_kernel(card, arch):
    n = FLASH_CALLS[arch]
    assert _bf16_prefill_launches(card, arch) == (n, n)


@pytest.mark.gpu
def test_bf16_prefill_at_head_dim_96_launches_the_tensor_core_kernel(card):
    """phi3-mini-3.8b's D 96, which the tensor-core kernel reads as two
    padded panels: in bf16 every launch (one a layer) takes the tensor-core
    route and none the SIMT one."""
    assert _cfg("phi3-mini-3.8b").d_head == 96
    n = FLASH_CALLS["phi3-mini-3.8b"]
    assert _bf16_prefill_launches(card, "phi3-mini-3.8b") == (n, n)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(FLASH_CALLS))
def test_float32_flash_prefill_matches_plain(card, arch):
    cfg = _cfg(arch)
    model = init_model(cfg, torch.Generator(card).manual_seed(1),
                       device=card)
    batch = _batch(cfg, card, seed=1)
    kernel.reset_launches()
    fused = _prefill(model, cfg, batch, flash=True)
    assert kernel.LAUNCHES["flash"] == FLASH_CALLS[arch]
    assert kernel.LAUNCHES["flash_wgmma"] == 0
    plain = _prefill(model, cfg, batch, flash=False)
    torch.testing.assert_close(fused, plain, rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,absorb", [
    ("granite-moe-1b-a400m", False), ("qwen2-vl-2b", False),
    ("minicpm3-4b", False), ("minicpm3-4b", True),
    ("deepseek-v2-lite-16b", False), ("deepseek-v2-lite-16b", True),
    ("phi3-mini-3.8b", False), ("nemotron-4-15b", False)])
def test_decode_matches_prefill(card, arch, absorb):
    cfg = _cfg(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    model = init_model(cfg, torch.Generator(card).manual_seed(2),
                       device=card)
    batch = _batch(cfg, card, b=3, s=12, seed=2)
    full = _prefill(model, cfg, batch, flash=True)
    cache = init_cache(cfg, 3, 16, device=card)
    for pos in range(12):
        logits, cache = decode_step(model, cfg, cache,
                                    batch["tokens"][:, pos], pos,
                                    mla_absorb=absorb)
        torch.testing.assert_close(logits, full[:, pos], rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(FLASH_CALLS))
def test_engine_serves_on_card(card, arch):
    cfg = _cfg(arch, "bfloat16")
    model = init_model(cfg, torch.Generator(card).manual_seed(3),
                       device=card)
    eng = ServeEngine(cfg, model, batch=2, max_len=32, device=card)
    rng = np.random.default_rng(3)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(2, 9))).astype(np.int32),
            max_new_tokens=4))
    eng.run_until_drained()
    assert sorted(eng.done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 5 for r in eng.done.values())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vlm_prefill_from_patch_grid_embeds(card, dtype):
    cfg = _cfg("qwen2-vl-2b", dtype)
    model = init_model(cfg, torch.Generator(card).manual_seed(4),
                       device=card)
    batch = _patch_grid_batch(cfg, card)
    kernel.reset_launches()
    fused = _prefill(model, cfg, batch, flash=True)
    torch.cuda.synchronize()
    n = FLASH_CALLS["qwen2-vl-2b"]
    assert kernel.LAUNCHES["flash"] == n
    assert kernel.LAUNCHES["flash_wgmma"] == (n if dtype == "bfloat16"
                                              else 0)
    assert torch.isfinite(fused).all()
    if dtype == "float32":
        plain = _prefill(model, cfg, batch, flash=False)
        torch.testing.assert_close(fused, plain, rtol=TOL, atol=TOL)
        s = batch["embeds"].shape[1]
        flat = {**batch, "positions3": torch.arange(s, device=card).expand(
            3, 2, s)}
        assert not torch.allclose(_prefill(model, cfg, flat, flash=False),
                                  plain, rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# the dropless MoE's grouped expert product (granite-4.0-h-small's shapes)
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("skew", ["routed", "one_empty", "all_in_one"])
def test_grouped_product_matches_the_plain_loop(card, skew):
    """granite-4.0-h-small's expert products (72 experts, d 4096, width
    768; 8192 tokens x top 10 rows) on the grouped GEMM against the loop
    over experts, bf16 at 2e-2 of the output's scale: rows routed at
    random, with one expert given no row, and with every row in one
    expert."""
    from repro_torch.kernels.moe_grouped import kernel as gk
    from repro_torch.kernels.moe_grouped import ops as gops
    from repro_torch.kernels.moe_grouped.ref import grouped_mm_ref
    from repro_torch.models.moe import sort_by_expert
    e, d, f, rows = 72, 4096, 768, 8192 * 10
    gen = torch.Generator(device=card).manual_seed(5)
    ids = torch.randint(0, e, (rows,), generator=gen, device=card)
    if skew == "one_empty":
        ids[ids == 7] = 8
    elif skew == "all_in_one":
        ids.fill_(31)
    order, offs = sort_by_expert(ids, e)
    x = torch.randn(rows, d, generator=gen, device=card,
                    dtype=torch.bfloat16)[order]
    for w_shape in ((e, d, f), (e, f, d)):
        w = torch.randn(w_shape, generator=gen, device=card,
                        dtype=torch.bfloat16) * 0.02
        xi = x if w_shape[1] == d else x[:, :f].contiguous()
        before = gk.LAUNCHES["grouped"]
        with torch.no_grad():
            got = gops.grouped_mm(xi, w, offs)
        want = grouped_mm_ref(xi.float(), w.float(), offs)
        torch.cuda.synchronize()
        assert gk.LAUNCHES["grouped"] == before + 1
        assert got.shape == (rows, w_shape[2]) and got.dtype == torch.bfloat16
        scale = want.abs().max()
        assert (got.float() - want).abs().max() <= 2e-2 * scale

