"""Strategy-contract harness for the PyTorch port: one parameterized
suite run against *every* entry in the port's own
`repro_torch.search.strategies.STRATEGIES` registry, so new or
third-party strategies are covered automatically the moment they
register (the port's trimlint R-REG pins the registry to this file).
The contract:

  * ask(max_n) returns a list of at most max_n in-bounds coordinate
    tuples (never more, never malformed, never out of the lattice);
  * tell accepts partial batches — any subset of what was asked,
    including the empty batch — without crashing or wedging;
  * exhausted, once True, is permanent and ask returns [] from then on;
  * same seed + same feedback => identical proposal sequences
    (per-seed determinism);
  * driven by `run_search`, every strategy respects the evaluation
    budget and terminates.

The synthetic drive never builds hardware or scores mapspaces — the
protocol is pure search logic — so the whole registry sweeps in
milliseconds; one run_search case per strategy checks the real driver
loop on a tiny task, on the CPU (`device="cpu"`).  The file imports no
JAX: it is `tests/test_strategy_contract.py` on the port.
"""
import pytest

from repro_torch.core import (Conv2D, FC, MapperConfig, Pool2D,
                              TaskDescription, generate_arch_space)
from repro_torch.search import (STRATEGIES, ArchSpace, MixSpace,
                                ResultCache, Strategy, make_strategy,
                                register, run_search)

ALL_STRATEGIES = sorted(STRATEGIES)

TASK = TaskDescription(
    name="tiny", input_shape=(8, 8, 3), batch_size=2,
    processing_type="Inference",
    layers=(Conv2D(8, (3, 3), (1, 1), (1, 1), name="c1"),
            Pool2D((2, 2), (2, 2), name="p1"),
            FC(10, name="fc")))
CFG = MapperConfig(max_mappings=200, seed=0)


def synthetic_space() -> ArchSpace:
    """A 4x3x2 lattice whose builder is never invoked — the contract
    drive exercises pure ask/tell protocol, no hardware evaluation."""
    return ArchSpace({"a": (1, 2, 4, 8), "b": (16, 32, 64), "c": (0, 1)},
                     lambda a, b, c: None)


def goal_fn(coords) -> float:
    """Deterministic synthetic goal (minimized at (1, 1, 1))."""
    return 1.0 + sum((x - 1) ** 2 for x in coords)


def obj_fn(coords):
    """Deterministic synthetic objective tuple for `observe`."""
    g = goal_fn(coords)
    return (g, 10.0 / g, 1.0 + coords[0])


def check_batch(space: ArchSpace, batch, max_n: int):
    assert isinstance(batch, list)
    assert len(batch) <= max_n
    for c in batch:
        assert isinstance(c, tuple) and len(c) == space.ndim
        for x, vals in zip(c, space.axis_values):
            assert isinstance(x, int) and 0 <= x < len(vals)


def drive(strat: Strategy, space: ArchSpace, *, rounds: int = 120,
          max_n: int = 4):
    """Ask/evaluate/tell loop with full contract checking; returns the
    proposal sequence."""
    proposed = []
    for _ in range(rounds):
        if strat.exhausted:
            break
        batch = strat.ask(max_n)
        check_batch(space, batch, max_n)
        if not batch:
            # nothing pending (every proposal was answered in-loop), so
            # an empty ask means the strategy is done proposing
            break
        proposed += batch
        for c in batch:
            strat.observe(c, obj_fn(c), True)
        strat.tell([(c, goal_fn(c)) for c in batch])
    return proposed


# ---------------------------------------------------------------------------
# the contract, per registered strategy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL_STRATEGIES)
@pytest.mark.parametrize("max_n", [1, 3, 64])
def test_ask_bounds_and_coord_validity(name, max_n):
    space = synthetic_space()
    proposed = drive(make_strategy(name, space, seed=0), space,
                     max_n=max_n)
    assert proposed, f"{name} proposed nothing"


@pytest.mark.parametrize("name", ALL_STRATEGIES)
def test_tell_accepts_partial_batches(name):
    space = synthetic_space()
    strat = make_strategy(name, space, seed=3)
    batch = strat.ask(4)
    check_batch(space, batch, 4)
    assert batch
    # empty tell, then the batch split into two partial tells
    strat.tell([])
    half = max(1, len(batch) // 2)
    strat.tell([(c, goal_fn(c)) for c in batch[:half]])
    strat.tell([(c, goal_fn(c)) for c in batch[half:]])
    # with all feedback delivered the strategy must keep functioning:
    # either it proposes again or it is exhausted — a wedged strategy
    # (empty asks forever, exhausted never set) fails here
    follow_up = drive(strat, space, rounds=20)
    assert follow_up or strat.exhausted


@pytest.mark.parametrize("name", ALL_STRATEGIES)
def test_exhausted_is_permanent_and_empty(name):
    space = synthetic_space()
    strat = make_strategy(name, space, seed=1)
    drive(strat, space, rounds=300, max_n=8)
    if strat.exhausted:
        for _ in range(3):
            assert strat.ask(8) == []
            assert strat.exhausted


@pytest.mark.parametrize("name", ["exhaustive", "random", "bandit"])
def test_finite_proposers_cover_and_exhaust(name):
    """Strategies that enumerate without replacement must cover the whole
    lattice exactly once, then report exhausted."""
    space = synthetic_space()
    strat = make_strategy(name, space, seed=2)
    proposed = drive(strat, space, rounds=300, max_n=5)
    assert strat.exhausted
    assert len(proposed) == len(set(proposed)) == space.size


@pytest.mark.parametrize("name", ALL_STRATEGIES)
def test_per_seed_determinism(name):
    space = synthetic_space()
    seqs = []
    for _ in range(2):
        strat = make_strategy(name, space, seed=7)
        seqs.append(drive(strat, space, rounds=40, max_n=3))
    assert seqs[0] == seqs[1]
    # and a different seed is allowed to (and for stochastic strategies
    # will) differ — only equality under the same seed is contractual
    assert seqs[0]


# ---------------------------------------------------------------------------
# the same contract over a heterogeneous MixSpace lattice
# ---------------------------------------------------------------------------
def synthetic_mix_space() -> MixSpace:
    """A 2-slot mix lattice (counts axis + per-slot copies of the base
    axes) whose builders are never invoked — strategies see only a
    bigger ArchSpace and must honor the identical protocol on it."""
    base = ArchSpace({"a": (1, 2, 4), "b": (16, 32)}, lambda a, b: None)
    return MixSpace(base, slots=2, counts=((1, 1), (2, 1)))


@pytest.mark.parametrize("name", ALL_STRATEGIES)
@pytest.mark.parametrize("max_n", [1, 4])
def test_mix_space_ask_bounds_and_coord_validity(name, max_n):
    space = synthetic_mix_space()
    assert space.axis_names[0] == "counts" and space.ndim == 5
    proposed = drive(make_strategy(name, space, seed=0), space,
                     rounds=200, max_n=max_n)
    assert proposed, f"{name} proposed nothing over a MixSpace"


@pytest.mark.parametrize("name", ALL_STRATEGIES)
def test_mix_space_per_seed_determinism(name):
    space = synthetic_mix_space()
    seqs = [drive(make_strategy(name, space, seed=11), space,
                  rounds=40, max_n=3) for _ in range(2)]
    assert seqs[0] == seqs[1] and seqs[0]


@pytest.mark.parametrize("name", ALL_STRATEGIES)
def test_mix_space_exhausted_is_permanent(name):
    space = synthetic_mix_space()
    strat = make_strategy(name, space, seed=1)
    drive(strat, space, rounds=500, max_n=8)
    if strat.exhausted:
        for _ in range(3):
            assert strat.ask(8) == []
            assert strat.exhausted


@pytest.mark.parametrize("name", ["exhaustive", "random", "bandit"])
def test_mix_space_finite_proposers_cover_and_exhaust(name):
    space = synthetic_mix_space()
    strat = make_strategy(name, space, seed=2)
    proposed = drive(strat, space, rounds=500, max_n=5)
    assert strat.exhausted
    assert len(proposed) == len(set(proposed)) == space.size


# ---------------------------------------------------------------------------
# budget-respecting termination through the real driver
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def shared_cache():
    return ResultCache()


@pytest.mark.parametrize("name", ALL_STRATEGIES)
def test_run_search_budget_and_termination(name, shared_cache):
    archs = list(generate_arch_space(num_pes=(16, 64), rf_words=(64,),
                                     gbuf_words=(2048, 8192), bits=16))
    rep = run_search(TASK, archs, goal="edp", cfg=CFG, strategy=name,
                     budget=3, seed=5, cache=shared_cache, device="cpu")
    assert rep.strategy == name
    assert 1 <= rep.n_evaluated <= 3
    assert len(rep.all_archs) == rep.n_evaluated
    assert rep.goal_value() == min(r.goal_value("edp")
                                   for r in rep.all_archs)


@pytest.mark.parametrize("name", ALL_STRATEGIES)
def test_run_search_budget_over_real_mix_space(name, shared_cache):
    """Every registered strategy drives a real (tiny) heterogeneous
    MixSpace through run_search within budget; every evaluated point is
    a scheduled MixResult."""
    base = ArchSpace.spatial(num_pes=(16, 64), rf_words=(64,),
                             gbuf_words=(2048,), bits=16)
    space = MixSpace(base, slots=2, counts=((1, 1),),
                     shared_bw_level="DRAM")
    rep = run_search(TASK, space, goal="edp", cfg=CFG, strategy=name,
                     budget=3, seed=5, cache=shared_cache, device="cpu")
    assert 1 <= rep.n_evaluated <= 3
    for res in rep.all_archs:
        assert res.hardware.n_members == 2
        assert len(res.assignment) == 3
    assert rep.goal_value() == min(r.goal_value("edp")
                                   for r in rep.all_archs)


# ---------------------------------------------------------------------------
# third-party registration rides the same harness
# ---------------------------------------------------------------------------
def test_third_party_registration_contract():
    @register("contract-dummy")
    class DummyStrategy(Strategy):
        """Minimal conforming strategy: first-k lattice walk."""

        def __init__(self, space, *, seed=0):
            super().__init__(space, seed=seed)
            self._it = iter(space.all_coords())

        def ask(self, max_n):
            out = []
            for c in self._it:
                out.append(c)
                if len(out) >= max_n:
                    break
            if len(out) < max_n:
                self._exhausted = True
            return out

    try:
        space = synthetic_space()
        strat = make_strategy("contract-dummy", space, seed=0)
        proposed = drive(strat, space, rounds=300, max_n=4)
        assert strat.exhausted and len(proposed) == space.size
        # determinism holds trivially; the registry served the new name
        assert "contract-dummy" in STRATEGIES
    finally:
        del STRATEGIES["contract-dummy"]
