"""Pluggable architecture-space search strategies (+ registry).

A strategy proposes candidate lattice coordinates and learns from their
goal values; the driver owns budget accounting, caching, Pareto upkeep and
evaluation (so strategies stay pure search logic).  Protocol:

    ask(max_n)  -> up to max_n coordinate tuples to evaluate next
                   ([] + exhausted=True means the strategy is done;
                    [] + exhausted=False means "tell me results first")
    tell(batch) -> list of (coords, goal_value) feedback, lower is better
    exhausted   -> True when the strategy has nothing more to propose

Strategies may re-propose visited coordinates; the driver answers those
from its memo without burning evaluation budget.

Registry: `@register("name")` + `make_strategy("name", space, ...)`;
third parties can register their own without touching this module.
"""
from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .space import ArchSpace, Coords

STRATEGIES: Dict[str, Callable[..., "Strategy"]] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        STRATEGIES[name] = cls
        return cls
    return deco


def make_strategy(name: str, space: ArchSpace, *, seed: int = 0,
                  **params) -> "Strategy":
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; "
                       f"registered: {sorted(STRATEGIES)}") from None
    return cls(space, seed=seed, **params)


class Strategy:
    """Base class; subclasses implement ask/tell."""

    name = "base"

    #: A lookahead strategy promises that `ask` is independent of
    #: `tell`/`observe` — proposals depend only on the space, the seed,
    #: and how many coordinates were already asked for.  The streaming
    #: driver may then propose round k+1 before round k's scores land
    #: without changing what gets evaluated.  Adaptive strategies
    #: (anneal/evolve/bandit/hv-evolve) must leave this False: the
    #: driver degrades them to the synchronous loop.
    lookahead = False

    def __init__(self, space: ArchSpace, *, seed: int = 0):
        self.space = space
        self.rng = random.Random(seed)
        self._exhausted = False
        self.constraints = None         # ConstraintSet, via set_constraints
        self._static_memo: Dict[Coords, bool] = {}

    @property
    def exhausted(self) -> bool:
        return self._exhausted

    def set_constraints(self, constraints) -> None:
        """The driver shares the search's ConstraintSet before the first
        ask, so strategies can repair proposals against *static* budgets
        (area caps need only the HardwareDesc) instead of wasting
        evaluation budget discovering them.  Optional: the driver still
        rejects statically infeasible proposals itself."""
        self.constraints = constraints

    def statically_feasible(self, coords: Coords) -> bool:
        """True unless the shared constraints reject the coordinate's
        hardware on sight (memoized; `space.at` caches the build)."""
        if self.constraints is None:
            return True
        ok = self._static_memo.get(coords)
        if ok is None:
            ok = not self.constraints.statically_infeasible(
                self.space.at(coords))
            self._static_memo[coords] = ok
        return ok

    def ask(self, max_n: int) -> List[Coords]:
        raise NotImplementedError

    def tell(self, batch: Sequence[Tuple[Coords, float]]) -> None:
        pass

    def observe(self, coords: Coords,
                objectives: Optional[Tuple[float, ...]],
                feasible: bool = True) -> None:
        """Optional multi-objective side channel: the driver reports each
        fresh evaluation's objective tuple (None for designs rejected
        before evaluation) and feasibility before the scalar `tell`.
        Scalar strategies ignore it; frontier-aware ones (hv-evolve)
        build their selection signal from it."""


@register("exhaustive")
class ExhaustiveStrategy(Strategy):
    """Seed-explorer parity: enumerate the whole lattice in Designer order."""

    lookahead = True        # pure enumeration: ask ignores tell entirely

    def __init__(self, space: ArchSpace, *, seed: int = 0):
        super().__init__(space, seed=seed)
        self._it = iter(space.all_coords())

    def ask(self, max_n: int) -> List[Coords]:
        out: List[Coords] = []
        for c in self._it:
            out.append(c)
            if len(out) >= max_n:
                break
        if len(out) < max_n:
            self._exhausted = True
        return out


@register("random")
class RandomStrategy(Strategy):
    """Budgeted sampling without replacement (uniform over the lattice)."""

    lookahead = True        # the sample stream is fixed by the seed

    _SHUFFLE_CAP = 1 << 20      # materialize + shuffle below this size

    def __init__(self, space: ArchSpace, *, seed: int = 0):
        super().__init__(space, seed=seed)
        if space.size <= self._SHUFFLE_CAP:
            coords = list(space.all_coords())
            self.rng.shuffle(coords)
            self._it = iter(coords)
            self._seen = None
        else:
            self._it = None
            self._seen = set()

    def ask(self, max_n: int) -> List[Coords]:
        out: List[Coords] = []
        if self._it is not None:
            for c in self._it:
                out.append(c)
                if len(out) >= max_n:
                    break
            if len(out) < max_n:
                self._exhausted = True
            return out
        tries = 0
        while len(out) < max_n and tries < 64 * max_n:
            tries += 1
            c = self.space.random_coords(self.rng)
            if c not in self._seen:
                self._seen.add(c)
                out.append(c)
        return out


@register("anneal")
class AnnealStrategy(Strategy):
    """Simulated annealing over the arch-parameter lattice.

    Scale-free Metropolis acceptance on relative goal deterioration:
    accept worse moves with prob exp(-(new/cur - 1) / T), T decaying
    geometrically.  Restarts from a random point when a chain stalls.
    """

    def __init__(self, space: ArchSpace, *, seed: int = 0, t0: float = 0.25,
                 alpha: float = 0.90, stall_restart: int = 8):
        super().__init__(space, seed=seed)
        self.t = self.t0 = t0
        self.alpha = alpha
        self.stall_restart = stall_restart
        self.current: Optional[Coords] = None
        self.cur_val = math.inf
        self.best: Optional[Coords] = None
        self.best_val = math.inf
        self._pending: Optional[Coords] = None
        self._stall = 0

    def _propose(self) -> Coords:
        if self.current is None:
            return self.space.random_coords(self.rng)
        if self._stall >= self.stall_restart:
            self._stall = 0
            self.t = self.t0          # reheat on restart
            return self.space.random_coords(self.rng)
        nbrs = self.space.neighbors(self.current)
        if not nbrs:
            return self.current
        return self.rng.choice(nbrs)

    def ask(self, max_n: int) -> List[Coords]:
        if self._pending is not None:
            return []                 # sequential chain: await feedback
        self._pending = self._propose()
        return [self._pending]

    def tell(self, batch: Sequence[Tuple[Coords, float]]) -> None:
        for coords, value in batch:
            if coords != self._pending:
                continue
            self._pending = None
            if value < self.best_val:
                self.best, self.best_val = coords, value
            accept = value <= self.cur_val
            if not accept and math.isfinite(value) and self.cur_val > 0 \
                    and math.isfinite(self.cur_val):
                delta = value / self.cur_val - 1.0
                accept = self.rng.random() < math.exp(-delta / max(self.t,
                                                                   1e-9))
            if accept:
                self._stall = 0 if value < self.cur_val else self._stall + 1
                self.current, self.cur_val = coords, value
            else:
                self._stall += 1
            self.t *= self.alpha


@register("evolve")
class EvolveStrategy(Strategy):
    """Generational evolutionary search: tournament selection, uniform
    per-axis crossover, +-1 lattice-step mutation, elitism."""

    def __init__(self, space: ArchSpace, *, seed: int = 0,
                 population: int = 8, elite: int = 2,
                 tournament: int = 3, mutate_p: float = 0.35):
        super().__init__(space, seed=seed)
        self.pop_size = max(2, min(population, space.size))
        self.elite = min(elite, self.pop_size - 1)
        self.tournament = tournament
        self.mutate_p = mutate_p
        self.population: List[Coords] = []
        self.fitness: Dict[Coords, float] = {}
        self._init_population()

    def _init_population(self) -> None:
        seen = set()
        tries = 0
        while len(self.population) < self.pop_size and tries < 200:
            tries += 1
            c = self.space.random_coords(self.rng)
            if c not in seen:
                seen.add(c)
                self.population.append(c)

    def _unevaluated(self) -> List[Coords]:
        return [c for c in self.population if c not in self.fitness]

    def ask(self, max_n: int) -> List[Coords]:
        return self._unevaluated()[:max_n]

    def _select(self, scored: List[Tuple[Coords, float]]) -> Coords:
        pick = self.rng.sample(scored, min(self.tournament, len(scored)))
        return min(pick, key=lambda cv: cv[1])[0]

    def _rank(self) -> List[Tuple[Coords, float]]:
        """Population as (coords, rank_value) best-first (ascending
        rank_value) — the hook subclasses override to change selection
        pressure without duplicating the generation loop."""
        return sorted(((c, self.fitness[c]) for c in self.population),
                      key=lambda cv: cv[1])

    def tell(self, batch: Sequence[Tuple[Coords, float]]) -> None:
        for coords, value in batch:
            self.fitness[coords] = value
        if self._unevaluated():
            return                      # generation still in flight
        scored = self._rank()
        nxt: List[Coords] = [c for c, _ in scored[: self.elite]]
        seen = set(nxt)
        tries = 0
        while len(nxt) < self.pop_size and tries < 50 * self.pop_size:
            tries += 1
            child = self.space.crossover(self._select(scored),
                                         self._select(scored), self.rng)
            child = self.space.mutate(child, self.rng, self.mutate_p)
            if child not in seen:
                seen.add(child)
                nxt.append(child)
        self.population = nxt


@register("bandit")
class BanditStrategy(Strategy):
    """Model-based search: a factorized per-axis surrogate with a UCB
    acquisition (lower-confidence bound — objectives are minimized).

    Each (axis, value) pair keeps the running mean of log-domain goal
    values observed at coordinates carrying it (the lattice axes are
    hardware knobs whose effects are roughly multiplicative, so the
    log-additive factorization is the natural cheap surrogate).  A
    candidate's acquisition is its predicted log-goal minus an
    exploration bonus that shrinks as its axis values accrue
    observations; each post-warmup ask proposes the unseen candidate
    with the lowest acquisition.  Deterministic per seed.

    Frontier awareness: the driver's `observe` hook feeds each feasible
    evaluation's objective tuple into per-objective surrogates; the
    model-driven pick then maximizes *optimistic hypervolume
    improvement* — each candidate's objectives are predicted by the
    factorized model, shrunk by the exploration bonus (UCB optimism in
    log space), and the candidate whose optimistic point would add the
    most volume to the observed frontier wins (scalar-goal UCB breaks
    ties and takes over when no candidate promises any gain), so picks
    spread across the trade-off surface instead of collapsing onto the
    scalar optimum.  Driven without `observe`, it degrades to the pure
    scalar-goal bandit.

    Replay-heavy by design: the strategy happily re-scores the whole
    lattice every round because the driver answers revisited coordinates
    from its memo and the persistent result cache makes even cold
    re-evaluations of previously-searched mapspaces enumeration-free —
    a warm cache turns the surrogate's greed into pure arithmetic.
    """

    _POOL_CAP = 4096        # acquisition pool: whole lattice below this

    def __init__(self, space: ArchSpace, *, seed: int = 0,
                 beta: float = 1.0, warmup: Optional[int] = None,
                 batch: int = 1):
        super().__init__(space, seed=seed)
        self.beta = beta
        self.warmup = (max(2, space.ndim + 1) if warmup is None
                       else max(1, warmup))
        # proposals per ask once the model is live: the strategy paces
        # itself below the driver's round size (like anneal's chain) so
        # every post-warmup pick uses all feedback gathered so far —
        # without this a large first round would spend the whole budget
        # inside warmup and the surrogate would never act
        self.batch = max(1, batch)
        # per-axis, per-value running (sum, count) of log-goal values
        self._stats: List[List[List[float]]] = [
            [[0.0, 0.0] for _ in vals] for vals in space.axis_values]
        self._global = [0.0, 0.0]
        # per-objective analogues, lazily sized by the first observe()
        self._ostats: Optional[List[List[List[List[float]]]]] = None
        self._oglobal: Optional[List[List[float]]] = None
        self._obs_vals: List[Tuple[float, ...]] = []
        self._proposed: set = set()

    # -- surrogate -------------------------------------------------------
    @staticmethod
    def _log(value: float) -> float:
        if not math.isfinite(value):
            return 700.0                # worse than any real log-goal
        return math.log(max(value, 1e-300))

    def _tell_one(self, coords: Coords, value: float) -> None:
        lv = self._log(value)
        self._global[0] += lv
        self._global[1] += 1.0
        for axis, c in enumerate(coords):
            s = self._stats[axis][c]
            s[0] += lv
            s[1] += 1.0

    def observe(self, coords: Coords,
                objectives: Optional[Tuple[float, ...]],
                feasible: bool = True) -> None:
        if objectives is None or not feasible \
                or not all(math.isfinite(v) for v in objectives):
            return
        k = len(objectives)
        if self._ostats is None:
            self._ostats = [[[[0.0, 0.0] for _ in range(k)]
                             for _ in vals]
                            for vals in self.space.axis_values]
            self._oglobal = [[0.0, 0.0] for _ in range(k)]
        if len(objectives) != len(self._oglobal):
            return                      # dimensionality changed mid-run
        self._obs_vals.append(tuple(float(v) for v in objectives))
        for j, v in enumerate(objectives):
            lv = self._log(v)
            self._oglobal[j][0] += lv
            self._oglobal[j][1] += 1.0
            for axis, c in enumerate(coords):
                s = self._ostats[axis][c][j]
                s[0] += lv
                s[1] += 1.0

    def _bonus(self, coords: Coords) -> float:
        """Exploration bonus in [0, ~sqrt(log N)]: large while a
        coordinate's axis values are under-observed."""
        n_total = max(self._global[1], 1.0)
        bonus = 0.0
        for axis, c in enumerate(coords):
            n = self._stats[axis][c][1]
            bonus += math.sqrt(math.log(1.0 + n_total) / (1.0 + n))
        return bonus / len(coords)

    def _centered_pred(self, coords: Coords, stats, glob) -> float:
        """Mean over axes of (axis-value mean - global mean) in log
        space — 0 for the unexplored, negative for promising values."""
        prior = glob[0] / max(glob[1], 1.0)
        pred = 0.0
        for axis, c in enumerate(coords):
            s, n = stats[axis][c]
            pred += (s / n - prior) if n else 0.0
        return pred / len(coords)

    def _acquisition(self, coords: Coords) -> float:
        """Scalar-goal lower-confidence bound (log space, minimized)."""
        return self._centered_pred(coords, self._stats, self._global) \
            - self.beta * self._bonus(coords)

    #: scalar log-space excess past which a candidate is considered
    #: known-bad (infeasible-region feedback is orders of magnitude
    #: above any real goal, real-goal spread is a few nats) and its
    #: frontier optimism is revoked
    _GATE_NATS = 5.0

    def _hvi_context(self):
        """Per-ask precomputation for `_hvi_gain` (everything that does
        not depend on the candidate): the observation front (pruned once
        — HV of a set equals HV of its non-dominated subset), its
        hypervolume and reference, per-objective transposed stats and
        global means."""
        from .pareto import hypervolume, non_dominated, ref_from_values
        ref = ref_from_values(self._obs_vals, margin=1.1)
        front = non_dominated(self._obs_vals)
        stats = [[[vv[j] for vv in ax] for ax in self._ostats]
                 for j in range(len(self._oglobal))]
        means = [g[0] / max(g[1], 1.0) for g in self._oglobal]
        return ref, front, hypervolume(front, ref), stats, means

    def _hvi_gain(self, coords: Coords, ctx) -> float:
        """Optimistic hypervolume improvement: predict each objective
        with the log-additive model, shrink by the exploration bonus
        (UCB optimism), and measure the volume the optimistic point
        would add to the observed frontier.  The per-objective model
        only ever sees *feasible* evaluations, so candidates the scalar
        (penalty-carrying) model already knows to be catastrophic —
        infeasible regions look merely "unexplored" to the objective
        stats — are gated out instead of winning on optimism."""
        from .pareto import hypervolume
        ref, front, front_hv, stats, means = ctx
        if self._centered_pred(coords, self._stats,
                               self._global) > self._GATE_NATS:
            return -1.0
        opt = self.beta * self._bonus(coords)
        pred = tuple(
            math.exp(means[j]
                     + self._centered_pred(coords, stats[j], glob) - opt)
            for j, glob in enumerate(self._oglobal))
        return hypervolume(front + [pred], ref) - front_hv

    # -- protocol --------------------------------------------------------
    def _pool(self) -> List[Coords]:
        if self.space.size <= self._POOL_CAP:
            return list(self.space.all_coords())
        seen = set()
        out: List[Coords] = []
        for _ in range(8 * self._POOL_CAP):
            c = self.space.random_coords(self.rng)
            if c not in seen:
                seen.add(c)
                out.append(c)
            if len(out) >= self._POOL_CAP:
                break
        return out

    #: post-warmup candidates that get the exact HVI score; larger pools
    #: are shortlisted by the scalar acquisition first, bounding each
    #: proposal at O(shortlist) hypervolume computations
    _HVI_SHORTLIST = 512

    def ask(self, max_n: int) -> List[Coords]:
        # above _POOL_CAP the pool is a random sample, and a tight
        # static constraint can leave a draw with nothing proposable —
        # redraw a few times before giving up so one unlucky sample
        # doesn't end the whole search (the driver stops on empty asks)
        redraws = 8 if self.space.size > self._POOL_CAP else 1
        fresh: List[Coords] = []
        for _ in range(redraws):
            fresh = [c for c in self._pool() if c not in self._proposed]
            if self.constraints is not None:
                # constraint repair: never spend budget on a coordinate
                # a static budget (area cap) already rejects on sight
                fresh = [c for c in fresh if self.statically_feasible(c)]
            if fresh:
                break
        if not fresh:
            if self.space.size <= self._POOL_CAP:
                self._exhausted = True
            return []
        told = int(self._global[1])
        pending = len(self._proposed) - told    # asked, not yet told
        if told + pending < self.warmup:
            # warmup: spread over the lattice before trusting the model,
            # and never over-ask past the warmup quota in one round
            self.rng.shuffle(fresh)
            out = fresh[:min(max_n, self.warmup - told - pending)]
        else:
            if self._obs_vals:
                if len(fresh) > self._HVI_SHORTLIST:
                    fresh.sort(key=lambda c: (self._acquisition(c), c))
                    fresh = fresh[: self._HVI_SHORTLIST]
                ctx = self._hvi_context()
                # most optimistic frontier gain first; scalar LCB breaks
                # ties and takes over when nothing promises a gain
                fresh.sort(key=lambda c: (-self._hvi_gain(c, ctx),
                                          self._acquisition(c), c))
            else:
                fresh.sort(key=lambda c: (self._acquisition(c), c))
            out = fresh[:min(max_n, self.batch)]
        self._proposed.update(out)
        return out

    def tell(self, batch: Sequence[Tuple[Coords, float]]) -> None:
        for coords, value in batch:
            self._tell_one(tuple(coords), value)


@register("hv-evolve")
class HvEvolveStrategy(EvolveStrategy):
    """Evolutionary search selecting by *hypervolume contribution*
    instead of the scalar goal: the fitness of a population member is
    how much frontier volume disappears when it is removed, so selection
    pressure spreads the population across the whole trade-off surface
    rather than collapsing onto the scalar optimum.  Members the driver
    marked infeasible (or that were never observed with objectives)
    rank strictly below every feasible member, ordered by their scalar
    (penalized) goal — the frontier stays feasible-only while search can
    still climb back out of the infeasible region.
    """

    def __init__(self, space: ArchSpace, *, seed: int = 0,
                 population: int = 8, elite: int = 2,
                 tournament: int = 3, mutate_p: float = 0.35):
        super().__init__(space, seed=seed, population=population,
                         elite=elite, tournament=tournament,
                         mutate_p=mutate_p)
        self._objs: Dict[Coords, Tuple[float, ...]] = {}

    def observe(self, coords: Coords,
                objectives: Optional[Tuple[float, ...]],
                feasible: bool = True) -> None:
        if feasible and objectives is not None \
                and all(math.isfinite(v) for v in objectives):
            self._objs[tuple(coords)] = tuple(objectives)

    def _rank(self) -> List[Tuple[Coords, float]]:
        """Population ranked best-first: feasible members by descending
        hypervolume contribution (scalar goal tie-break), then the rest
        by ascending scalar goal.  Returned as (coords, rank_value)
        pairs with *ascending* rank_value = better, so the inherited
        tournament/elite/generation machinery applies unchanged."""
        from .pareto import hypervolume, ref_from_values
        front = [c for c in self.population if c in self._objs]
        rest = [c for c in self.population if c not in self._objs]
        ranked: List[Tuple[Coords, float]] = []
        if front:
            vals = [self._objs[c] for c in front]
            ref = ref_from_values(vals, margin=1.1)
            total = hypervolume(vals, ref)
            contrib = []
            for i, c in enumerate(front):
                others = vals[:i] + vals[i + 1:]
                gain = total - hypervolume(others, ref)
                contrib.append((c, gain))
            # rank_value: -contribution (ascending = most volume first),
            # scalar goal breaks exact-tie contributions (e.g. zero-gain
            # duplicates) deterministically
            contrib.sort(key=lambda cg: (-cg[1],
                                         self.fitness.get(cg[0], math.inf)))
            ranked += [(c, float(i)) for i, (c, _) in enumerate(contrib)]
        base = float(len(ranked))
        rest.sort(key=lambda c: (self.fitness.get(c, math.inf), c))
        ranked += [(c, base + i) for i, c in enumerate(rest)]
        return ranked
