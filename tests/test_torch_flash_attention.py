"""The port's flash-attention op (`repro_torch.kernels.flash_attention`) on
the CPU, where it computes its plain PyTorch version, against the JAX
package's Pallas kernel in interpret mode and its pure-jnp oracle, on the
same seeded numpy inputs.

Tolerances as the reference's kernel tests state them
(tests/test_kernels.py): 2e-5 in float32 (sums in another order), 2e-2 in
bfloat16 (outputs rounded to bf16 after different fp32 sums)."""
import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.configs import reduced_config
from repro_torch.configs.base import inv_sqrt_f32
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.models import attention, forward, init_model

# (b, s, h, hkv, d): tests/test_kernels.py's FLASH_SHAPES, then the head
# dims 96 (MHA, phi3-mini-3.8b's) and 80 (GQA) at S 256 (the Pallas
# wrapper needs S % 128 == 0)
FLASH_SHAPES = [
    (2, 256, 4, 2, 64), (1, 128, 8, 8, 128), (2, 512, 4, 1, 64),
    (1, 256, 2, 2, 128), (1, 256, 4, 4, 96), (2, 256, 4, 2, 80),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, s, h, hkv, d, seed=42):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,hkv,d", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_matches_pallas_and_oracle(b, s, h, hkv, d, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(b, s, h, hkv, d)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    before = dict(kernel.LAUNCHES)
    got = ops.flash_attention(tq, tk, tv)
    assert kernel.LAUNCHES == before          # the CPU runs no kernel
    assert got.dtype == tdt and got.shape == tq.shape
    _close(got, jax_flash(jq, jk, jv, interpret=True), tol)
    _close(got, jax_ref(jq, jk, jv), tol)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [1, 37, 100])
def test_plain_version_matches_oracle_at_ragged_lengths(s, causal):
    """The port takes any S >= 1 (the Pallas wrapper needs S % block == 0,
    so only the oracle is held against it here)."""
    arrays = _inputs(2, s, 6, 2, 64, seed=s)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in arrays),
                              causal=causal)
    _close(got, jax_ref(*(jnp.asarray(a) for a in arrays), causal=causal),
           2e-5)


def _bad_inputs():
    def qkv(b=1, s=8, h=4, hkv=2, d=64, dtype=torch.float32):
        return [torch.zeros(shape, dtype=dtype) for shape in
                ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]
    q, k, v = qkv()
    return {
        "float16": (qkv(dtype=torch.float16), "float32 or bfloat16"),
        "float64": (qkv(dtype=torch.float64), "float32 or bfloat16"),
        "mixed-dtypes": ([q, k.bfloat16(), v], "one type"),
        "3-d": ([q[0], k[0], v[0]], r"\[B,S,H,D\]"),
        "k-length": ([q, k[:, :4], v[:, :4]], "k/v must be"),
        "v-shape": ([q, k, v[:, :, :1]], "k/v must be"),
        "heads": (qkv(h=3, hkv=2), "not a multiple"),
        "head-dim-32": (qkv(d=32), "head dim 32"),
        "head-dim-48": (qkv(d=48), "head dim 48"),
        "head-dim-stride": ([torch.zeros(1, 8, 4, 128)[..., ::2], k, v],
                            "unit stride"),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    (q, k, v), match = _bad_inputs()[case]
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v)


def test_kernel_entry_refuses_cpu_tensors():
    """No fallback inside the kernel's own entry: a CPU tensor is an
    error there (only `ops.flash_attention` picks the plain version)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 1, 64))
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        kernel.flash_attention_fwd(q, k, v)


def test_plain_version_is_ref():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 20, 4, 2, 80))
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v))


def _layout(dtype, d, layout):
    """q/k/v [2, 40, 6|2, d] of `dtype`: contiguous ("aligned"), with a head
    stride of d + 1 elements ("misaligned-stride"), or starting one element
    into their storage ("misaligned-pointer")."""
    out = []
    for h in (6, 2, 2):
        if layout == "misaligned-stride":
            t = torch.zeros(2, 40, h, d + 1, dtype=dtype)[..., :d]
        elif layout == "misaligned-pointer":
            t = torch.zeros(2 * 40 * h * d + 1, dtype=dtype)[1:].view(
                2, 40, h, d)
        else:
            t = torch.zeros(2, 40, h, d, dtype=dtype)
        out.append(t)
    return out


@pytest.mark.parametrize("layout", ["aligned", "misaligned-stride",
                                    "misaligned-pointer"])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_route_by_dtype_head_dim_and_alignment(dtype, d, layout):
    """The tensor-core kernel for bf16 at every head dim read through TMA
    (base pointers and strides 16-byte aligned; D 80 and 96 as two padded
    panels); the SIMT kernel for float32 and misaligned bf16."""
    q, k, v = _layout(DTYPES[dtype][1], d, layout)
    kernel.check_inputs(q, k, v)                  # both routes' inputs
    want = ("wgmma" if dtype == "bfloat16" and layout == "aligned"
            else "simt")
    before = dict(kernel.LAUNCHES)
    assert kernel.choose_route(q, k, v) == want
    assert kernel.LAUNCHES == before                # chosen before a launch


def test_route_takes_packed_kv_views():
    """K/V as views into one packed [B,S,2*Hkv,D] tensor keep 16-byte
    strides, so bf16 at D=64 stays on the tensor-core route."""
    q = torch.zeros(2, 50, 6, 64, dtype=torch.bfloat16)
    kv = torch.zeros(2, 50, 4, 64, dtype=torch.bfloat16)
    assert kernel.choose_route(q, kv[:, :, :2], kv[:, :, 2:]) == "wgmma"
    # a dimension of extent 1 reads only coordinate 0: its stride is free
    q1 = torch.zeros(1, 50, 6, 65, dtype=torch.bfloat16)[..., :64]
    assert kernel.choose_route(q1[:, :1, :1], kv[:1, :1, :1],
                               kv[:1, :1, 1:2]) == "wgmma"


@pytest.mark.parametrize("n_kv_heads", [8, 2], ids=["mha", "gqa"])
def test_phi3_shaped_attention_takes_the_tensor_core_route(n_kv_heads):
    """phi3-mini-3.8b's attention (bf16, head dim 96) through the model's
    own projections and `sdpa`: every layer hands the flash hook q, k and
    v that `choose_route` sends to the tensor-core kernel, MHA as phi3
    has it and GQA."""
    cfg = dataclasses.replace(reduced_config("phi3-mini-3.8b"), n_heads=8,
                              n_kv_heads=n_kv_heads, head_dim=96,
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 40)))
    seen = []

    def hook(q, k, v, *, scale):
        seen.append((tuple(q.shape), tuple(k.shape),
                     kernel.choose_route(q, k, v)))
        return ops.flash_attention(q, k, v, scale=scale)

    with torch.no_grad():
        attention.set_flash_impl(hook)
        try:
            logits = forward(model, cfg, {"tokens": tokens},
                             logits_mode="last")
        finally:
            attention.set_flash_impl(None)
    assert seen == [((2, 40, 8, 96), (2, 40, n_kv_heads, 96), "wgmma")] \
        * cfg.n_layers
    assert logits.shape == (2, 1, cfg.vocab)
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_kernel_wrapper_raises_on_what_neither_route_takes(case):
    """The kernel-level entry checks its inputs before it looks at the
    device or chooses a route: what neither kernel takes raises there."""
    (q, k, v), match = _bad_inputs()[case]
    before = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        kernel.flash_attention_fwd(q, k, v)
    assert kernel.LAUNCHES == before


def test_c_entry_binding_matches_its_arguments():
    """`_bind` declares the C entry's 23 arguments: 4 pointers, 8 ints
    (the route last), 9 strides, the softmax scale (a float) and the
    stream."""
    class Fn:
        argtypes = restype = None

    class Lib:
        flash_attention_fwd = Fn()
        flash_attention_tc_smem_bytes = Fn()

    lib = Lib()
    kernel._bind(lib)
    assert len(lib.flash_attention_fwd.argtypes) == 23
    assert lib.flash_attention_fwd.argtypes[21] is ctypes.c_float
    assert kernel.ROUTES == {"simt": 0, "wgmma": 1}


@pytest.mark.parametrize("path", ["flash", "blocked", "plain"])
def test_a_given_softmax_scale_reaches_every_attention_path(path):
    """`sdpa(..., scale=s)` (Granite 4.0-H's attention_multiplier) through
    the flash hook (the op's plain version here), the blocked path and the
    plain path equals softmax(s q k^T) v; the default stays D^-0.5."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn(2, 64, 4, 64, generator=g) * 3
    k, v = torch.randn(2, 2, 64, 2, 64, generator=g)
    kk, vv = k.repeat_interleave(2, 2), v.repeat_interleave(2, 2)
    mask = torch.ones(64, 64, dtype=torch.bool).tril()

    def want(scale):
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
        w = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        return torch.einsum("bhqk,bkhd->bqhd", w, vv)
    before = attention.BLOCKED_ATTN_THRESHOLD
    try:
        if path == "flash":
            ops.install()
        elif path == "blocked":
            attention.set_blocked_threshold(0)
        got = attention.sdpa(q, k, v, scale=1 / 64)
        default = attention.sdpa(q, k, v)
    finally:
        attention.set_flash_impl(None)
        attention.set_blocked_threshold(before)
    torch.testing.assert_close(got, want(1 / 64), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(default, want(64 ** -0.5), rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, scale=1 / 64), want(1 / 64),
        rtol=2e-5, atol=2e-5)



@pytest.mark.parametrize("d", kernel.SUPPORTED_D)
def test_default_scale_is_one_float32_value(d):
    """Without a given scale every path multiplies by `inv_sqrt_f32(D)`,
    `1.0f / sqrtf(D)`; the tensor-core kernel's log2 form, log2(e) times
    that float, equals log2(e) / sqrtf(D) at every D it takes, so the
    launches of models at the default scale read the floats they did
    when the launcher computed them itself.  A config's `softmax_scale`
    is that value, or its `attention_multiplier`."""
    one, log2e = np.float32(1), np.float32(1.4426950408889634)
    root = np.sqrt(np.float32(d))
    s = inv_sqrt_f32(d)
    assert np.float32(s) == one / root and float(np.float32(s)) == s
    assert log2e * np.float32(s) == log2e / root
    cfg = dataclasses.replace(reduced_config("phi3-mini-3.8b"), head_dim=d)
    assert cfg.softmax_scale == s
    granite = dataclasses.replace(cfg, attention_multiplier=1 / 128)
    assert granite.softmax_scale == 1 / 128
