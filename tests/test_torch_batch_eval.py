"""Port's batched oracle (repro_torch.core.batch_eval) against the JAX
package's `evaluate_batch` / `evaluate_batch_multi` on identical packed
arrays, on the CPU.

Scores agree to rtol 2e-4 (both compute in float32; cumulative products
and reductions round in different orders), validity exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (MapperConfig, alexnet_cifar, analyze,
                        build_packed_mapspace, conv2d_workload,
                        make_fpga_arch, make_spatial_arch)
from repro.core import batch_eval as jbe
from repro_torch import convert
from repro_torch.core import batch_eval as tbe

TW = analyze(alexnet_cifar(batch_size=4))
RTOL = 2e-4
SCORE_KEYS = ("cycles", "dynamic_pj", "static_pj", "energy_pj", "edp",
              "pes_used")


def _arch(zero_skip=True, num_pes=64, rf_words=128, gbuf_words=16 * 1024):
    return make_spatial_arch(num_pes=num_pes, rf_words=rf_words,
                             gbuf_words=gbuf_words, bits=16,
                             zero_skip=zero_skip)


SLIDING_WL = conv2d_workload(batch=2, in_ch=16, out_ch=32, out_h=7,
                             out_w=9, kr=3, ks=3, stride=(2, 1),
                             dilation=(2, 2), name="dilated.FW",
                             input_zero_frac=0.2, weight_zero_frac=0.1)

CASES = [
    # (id, workload, hw factory, bypass)
    ("conv_bypass_mix", TW.intra[2], _arch, True),
    ("conv_nobypass", TW.intra[2], _arch, False),
    ("depthwise_pool", TW.intra[1], _arch, True),
    ("no_zeroskip", TW.intra[4], lambda: _arch(zero_skip=False), True),
    ("strided_first_layer", TW.intra[0], _arch, True),
    ("strided_dilated", SLIDING_WL, _arch, True),
    ("fc_wg", TW.intra[12], _arch, True),
    ("fpga_two_levels", TW.intra[2],
     lambda: make_fpga_arch(name="fpga", num_pes=64, cache_kb=64), True),
]


def _packed(wl, hw, bypass, n=160, seed=1):
    cfg = MapperConfig(max_mappings=600, seed=seed, enable_bypass=bypass)
    pm = build_packed_mapspace(wl, hw, cfg)
    assert len(pm), "empty mapspace would vacuously pass"
    return (pm.static, pm.factors[:n], pm.rank[:n], pm.store[:n],
            pm.eligible[:n])


def _port_static(st):
    return convert.static_from_dict(dataclasses.asdict(st))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _compare(port, ref):
    for k in SCORE_KEYS:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, err_msg=k)
    np.testing.assert_array_equal(port["valid"].numpy(),
                                  np.asarray(ref["valid"]))


@pytest.mark.parametrize("name,wl,hw,bypass", CASES,
                         ids=[c[0] for c in CASES])
def test_evaluate_batch_matches_jax(name, wl, hw, bypass):
    st, f, r, s, elig = _packed(wl, hw(), bypass)
    if bypass and name != "depthwise_pool":
        assert not elig.all(), "bypass case must hold bypass rows"
    ref = jbe.evaluate_batch(st, f, r, s)
    out = tbe.evaluate_batch(_port_static(st), *_t(f, r, s))
    _compare(out, ref)


def test_validity_on_tight_buffers():
    """Rows built for a roomy arch, scored on a small one: buffer and
    fanout checks reject some of them, identically in both packages."""
    _, f, r, s, _ = _packed(TW.intra[2], _arch(), True)
    st = jbe.make_static(_arch(num_pes=16, rf_words=32,
                               gbuf_words=2 * 1024), TW.intra[2])
    ref = jbe.evaluate_batch(st, f, r, s)
    valid = np.asarray(ref["valid"])
    assert valid.any() and not valid.all()
    _compare(tbe.evaluate_batch(_port_static(st), *_t(f, r, s)), ref)


def _multi_inputs():
    """Rows of three architectures and two workloads sharing a BatchSig."""
    parts = [_packed(TW.intra[2], _arch(), True, n=70),
             _packed(TW.intra[2], _arch(num_pes=256, rf_words=256,
                                        gbuf_words=64 * 1024), True, n=50,
                     seed=4),
             _packed(TW.intra[4], _arch(zero_skip=False), False, n=40)]
    sig = jbe.sig_of(parts[0][0])
    assert all(jbe.sig_of(p[0]) == sig for p in parts)
    per = [jbe.params_of(p[0], len(p[1])) for p in parts]
    params = {k: np.concatenate([q[k] for q in per]) for k in per[0]}
    f, r, s = (np.concatenate([p[i] for p in parts]) for i in (1, 2, 3))
    return parts, sig, params, f, r, s


def test_params_of_matches_jax():
    parts, _, params, _, _, _ = _multi_inputs()
    per = [tbe.params_of(_port_static(p[0]), len(p[1])) for p in parts]
    for k, v in params.items():
        np.testing.assert_array_equal(
            np.concatenate([q[k] for q in per]), v, err_msg=k)


def test_evaluate_batch_multi_matches_jax():
    _, sig, params, f, r, s = _multi_inputs()
    ref = jbe.evaluate_batch_multi(
        sig, {k: jnp.asarray(v) for k, v in params.items()}, f, r, s)
    tsig = tbe.BatchSig(**dataclasses.asdict(sig))
    out = tbe.evaluate_batch_multi(
        tsig, {k: torch.from_numpy(v) for k, v in params.items()},
        *_t(f, r, s))
    _compare(out, ref)


def test_evaluate_batch_multi_matches_single_rows():
    parts, sig, params, f, r, s = _multi_inputs()
    tsig = tbe.BatchSig(**dataclasses.asdict(sig))
    out = tbe.evaluate_batch_multi(
        tsig, {k: torch.from_numpy(v) for k, v in params.items()},
        *_t(f, r, s))
    off = 0
    for st, pf, pr, ps, _ in parts:
        single = tbe.evaluate_batch(_port_static(st), *_t(pf, pr, ps))
        n = len(pf)
        for k in ("cycles", "energy_pj"):
            np.testing.assert_allclose(out[k][off:off + n].numpy(),
                                       single[k].numpy(), rtol=RTOL)
        assert torch.equal(out["valid"][off:off + n], single["valid"])
        off += n


def test_batch_scores_needs_explicit_cpu_without_card():
    st, f, r, s, _ = _packed(TW.intra[2], _arch(), True, n=8)
    scores, valid = tbe.batch_scores_arrays(_port_static(st), f, r, s,
                                            "edp", device="cpu")
    assert scores.shape == (8,) and valid.dtype == bool
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbe.batch_scores_arrays(_port_static(st), f, r, s, "edp")


def test_pack_matches_jax():
    cfg = MapperConfig(max_mappings=200, seed=0)
    from repro.core import build_mapspace
    from repro_torch.core import mapper as tmapper
    from repro_torch.core import task_analyst as tta
    hw = _arch()
    ms = build_mapspace(TW.intra[2], hw, cfg).mappings[:50]
    thw = convert.hardware_from_dict(dataclasses.asdict(hw))
    twl = tta.analyze(tta.alexnet_cifar(batch_size=4)).intra[2]
    tms = tmapper.build_mapspace(twl, thw, tmapper.MapperConfig(
        max_mappings=200, seed=0)).mappings[:50]
    for a, b in zip(jbe.pack(ms), tbe.pack(tms)):
        np.testing.assert_array_equal(a, b)
