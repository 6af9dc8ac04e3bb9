"""The port's continuous-batching engine (`repro_torch.serve.engine`) on
the CPU:

  * against the JAX package's `ServeEngine`, from the same parameters and
    the same requests: every request's `out_tokens` are equal (greedy
    argmax over float32 logits that agree to ~1e-6, see
    tests/test_torch_models.py and tests/test_torch_ssm.py), for the
    dense model and for the ssm and hybrid families, whose slots carry
    conv/ssm states that the token-by-token prefill advances for every
    slot, as the reference's does;
  * the slot invariants of tests/test_serve_engine.py, over a stub decode
    (token t always emits t+1, as one-hot logits)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import init_model as jax_init_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import reduced_config
from repro_torch.models import init_model
from repro_torch.serve import Request, ServeEngine

ARCH = "smollm-135m"
CFG = reduced_config(ARCH)


def _requests(make, n, seed=0, max_new_tokens=4, vocab=CFG.vocab):
    rng = np.random.default_rng(seed)
    return [make(rid=rid, prompt=rng.integers(
        0, vocab, size=int(rng.integers(1, 7))).astype(np.int32),
        max_new_tokens=max_new_tokens) for rid in range(n)]


@pytest.mark.parametrize("batch,max_len,eos_id",
                         [(2, 32, -1), (3, 12, -1), (2, 32, 5)])
def test_engine_matches_jax(batch, max_len, eos_id):
    """Same converted params, same requests -> same tokens per request,
    with slots recycled at budget, EOS and max_len."""
    cj = jax_reduced_config(ARCH)
    params, _ = jax_init_model(cj, jax.random.PRNGKey(0))
    model = convert.load_model_params(
        init_model(CFG, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    ref = JaxServeEngine(cj, params, batch=batch, max_len=max_len,
                         eos_id=eos_id)
    eng = ServeEngine(CFG, model, batch=batch, max_len=max_len,
                      eos_id=eos_id, device="cpu")
    for r in _requests(JaxRequest, 5):
        ref.submit(r)
    for r in _requests(Request, 5):
        eng.submit(r)
    assert eng.run_until_drained() == ref.run_until_drained()
    assert sorted(eng.done) == sorted(ref.done) == list(range(5))
    for rid in ref.done:
        assert eng.done[rid].out_tokens == ref.done[rid].out_tokens, rid


@pytest.mark.parametrize("batch,max_len,eos_id", [(2, 32, -1), (3, 12, -1)])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_engine_matches_jax(arch, batch, max_len, eos_id):
    cj, ct = jax_reduced_config(arch), reduced_config(arch)
    params, _ = jax_init_model(cj, jax.random.PRNGKey(0))
    model = convert.load_model_params(
        init_model(ct, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    ref = JaxServeEngine(cj, params, batch=batch, max_len=max_len,
                         eos_id=eos_id)
    eng = ServeEngine(ct, model, batch=batch, max_len=max_len,
                      eos_id=eos_id, device="cpu")
    for r in _requests(JaxRequest, 5, vocab=ct.vocab):
        ref.submit(r)
    for r in _requests(Request, 5, vocab=ct.vocab):
        eng.submit(r)
    assert eng.run_until_drained() == ref.run_until_drained()
    assert sorted(eng.done) == sorted(ref.done) == list(range(5))
    for rid in ref.done:
        assert eng.done[rid].out_tokens == ref.done[rid].out_tokens, rid


# ---------------------------------------------------------------------------
# slot invariants over a stub decode
# ---------------------------------------------------------------------------
def make_engine(batch=2, max_len=64, eos_id=-1) -> ServeEngine:
    """Engine with a deterministic stub decode: next(t) = (t+1) % vocab,
    returned as one-hot logits.  params are never touched."""
    eng = ServeEngine(CFG, None, batch=batch, max_len=max_len,
                      eos_id=eos_id, device="cpu")

    def fake_decode(params, cache, toks, pos):
        logits = torch.zeros((batch, CFG.vocab))
        for i, t in enumerate(toks.tolist()):
            logits[i, (int(t) + 1) % CFG.vocab] = 1.0
        return logits, cache

    eng._decode = fake_decode
    return eng


def prompt(*toks) -> np.ndarray:
    return np.asarray(toks, np.int32)


def _empty_prompt_rejected_at_submit():
    eng = make_engine()
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(rid=0, prompt=prompt()))
    assert eng.run_until_drained() == 0
    assert eng.done == {}


def _single_token_prompt_is_fine():
    eng = make_engine()
    eng.submit(Request(rid=0, prompt=prompt(3), max_new_tokens=2))
    eng.run_until_drained()
    assert eng.done[0].out_tokens == [4, 5, 6]


def _eos_frees_slot():
    eng = make_engine(eos_id=7)
    eng.submit(Request(rid=0, prompt=prompt(5), max_new_tokens=50))
    ticks = eng.run_until_drained()
    assert eng.done[0].out_tokens == [6, 7]
    assert all(r is None for r in eng.slot_req)
    assert ticks < 50


def _budget_exhaustion_frees_slot():
    eng = make_engine(eos_id=-1)
    eng.submit(Request(rid=0, prompt=prompt(1, 2), max_new_tokens=3))
    eng.run_until_drained()
    assert eng.done[0].out_tokens == [3, 4, 5, 6]
    assert all(r is None for r in eng.slot_req)


def _slot_never_double_assigned():
    eng = make_engine(batch=2)
    n_req = 5
    for rid in range(n_req):
        eng.submit(Request(rid=rid, prompt=prompt(1 + rid),
                           max_new_tokens=3))
    ticks = 0
    while (eng.pending or any(r is not None for r in eng.slot_req)) \
            and ticks < 200:
        active = [r.rid for r in eng.slot_req if r is not None]
        assert len(active) == len(set(active)), "slot double-assigned"
        assert len(active) <= eng.batch
        eng.step()
        ticks += 1
    assert ticks < 200
    assert sorted(eng.done) == list(range(n_req))
    assert all(len(eng.done[r].out_tokens) == 4 for r in range(n_req))


def _drains_with_single_slot():
    eng = make_engine(batch=1)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=prompt(2, 3), max_new_tokens=2))
    assert eng.run_until_drained() < 10_000
    assert sorted(eng.done) == [0, 1, 2]
    assert not eng.pending
    assert all(r is None for r in eng.slot_req)


def _max_len_frees_slot():
    eng = make_engine(batch=1, max_len=6)
    eng.submit(Request(rid=0, prompt=prompt(1, 2, 3), max_new_tokens=50))
    eng.run_until_drained()
    # positions 3 and 4 decode; at slot_pos 5 == max_len - 1 the slot frees
    assert eng.done[0].out_tokens == [4, 5, 6]


def _shared_position_is_the_largest_active():
    eng = make_engine(batch=2)
    seen = []
    stub = eng._decode

    def spy(params, cache, toks, pos):
        seen.append(pos)
        return stub(params, cache, toks, pos)

    eng._decode = spy
    eng.submit(Request(rid=0, prompt=prompt(1, 2, 3, 4), max_new_tokens=2))
    eng.submit(Request(rid=1, prompt=prompt(9), max_new_tokens=2))
    eng.step()
    # prefill: 4 + 1 token steps at 0..3 and 0; the tick decodes both at 4
    assert seen == [0, 1, 2, 3, 0, 4]


SLOT_CASES = {f.__name__.lstrip("_"): f for f in (
    _empty_prompt_rejected_at_submit, _single_token_prompt_is_fine,
    _eos_frees_slot, _budget_exhaustion_frees_slot,
    _slot_never_double_assigned, _drains_with_single_slot,
    _max_len_frees_slot, _shared_position_is_the_largest_active)}


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_slot_invariants(case):
    SLOT_CASES[case]()
