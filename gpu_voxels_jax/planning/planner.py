"""Sampling-based motion planning over the voxel validity tier.

The reference application plans with OMPL's LBKPIECE1 over a
GvlOmplPlannerHelper StateValidityChecker/MotionValidator and simplifies the
result with ompl::geometric::PathSimplifier
(gvl_ompl_planning/gvl_ompl_planner.cpp:56-160,
gvl_ompl_planner_helper.cpp:169-280). OMPL is a CPU library whose per-state
callbacks would serialize a device pipeline, so here the planner is part of the
library: RRT-Connect over a bounded joint space, where every tree extension
validates its WHOLE interpolated segment in one batched (vmapped) device
program via `MotionValidator.check_motion` (planning/validity.py). Sampling
and nearest-neighbor bookkeeping stay on host (they are a few thousand
float ops); all collision math runs on device through the same compiled
batch programs the validity tier already serves.

Determinism: all randomness comes from one `numpy.random.Generator` seeded
at construction — identical seeds replay identical trees and shortcuts,
which is what lets tests assert planner behavior exactly.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .validity import MotionValidator


@dataclass(frozen=True)
class JointSpace:
    """Bounded R^n joint space (ob::RealVectorStateSpace + RealVectorBounds,
    gvl_ompl_planner.cpp:56-66). Distance is the max-abs metric the motion
    validator already discretizes by (validity.py segment_states)."""

    lower: np.ndarray
    upper: np.ndarray

    @classmethod
    def symmetric(cls, n: int, bound: float = np.pi) -> "JointSpace":
        b = np.full((n,), float(bound), np.float32)
        return cls(-b, b)

    def __post_init__(self):
        lo = np.asarray(self.lower, np.float32)
        hi = np.asarray(self.upper, np.float32)
        if lo.shape != hi.shape or lo.ndim != 1:
            raise ValueError("bounds must be matching 1-D arrays")
        if not (lo <= hi).all():
            raise ValueError("lower bound exceeds upper bound")
        object.__setattr__(self, "lower", lo)
        object.__setattr__(self, "upper", hi)

    @property
    def dim(self) -> int:
        return int(self.lower.shape[0])

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        return rng.uniform(self.lower, self.upper).astype(np.float32)

    def distance(self, a, b) -> float:
        return float(np.max(np.abs(np.asarray(b, np.float32) - np.asarray(a, np.float32))))

    def contains(self, q) -> bool:
        q = np.asarray(q, np.float32)
        return bool((q >= self.lower).all() and (q <= self.upper).all())


@dataclass
class Path:
    """A piecewise-linear joint-space path (og::PathGeometric analogue)."""

    states: np.ndarray  # float32 [N, dim]

    def __post_init__(self):
        self.states = np.atleast_2d(np.asarray(self.states, np.float32))

    def __len__(self) -> int:
        return int(self.states.shape[0])

    def length(self) -> float:
        if len(self) < 2:
            return 0.0
        return float(np.sum(np.max(np.abs(np.diff(self.states, axis=0)), axis=1)))

    def interpolate(self, resolution: float) -> np.ndarray:
        """Densify to `resolution` (max-abs) per step: PathGeometric::
        interpolate() before visualizeSolution's swept-volume insert
        (gvl_ompl_planner_helper.cpp:102-137). Returns float32 [M, dim]
        including both endpoints."""
        if len(self) < 2:
            return self.states.copy()
        out = [self.states[:1]]
        for a, b in zip(self.states[:-1], self.states[1:]):
            dist = float(np.max(np.abs(b - a)))
            n = max(int(np.ceil(dist / float(resolution))), 1)
            r = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)[1:, None]
            out.append(a[None, :] * (1 - r) + b[None, :] * r)
        return np.concatenate(out, axis=0)


@dataclass
class PlannerResult:
    path: Optional[Path]
    iterations: int
    motion_checks: int
    states_checked: int
    plan_seconds: float

    @property
    def solved(self) -> bool:
        return self.path is not None


class _Tree:
    """Append-only RRT tree; nearest neighbor = vectorized max-abs scan
    (host arrays grow amortized-doubling so the scan stays one numpy op)."""

    def __init__(self, root: np.ndarray):
        self._states = np.empty((16, root.shape[0]), np.float32)
        self._parent = np.empty((16,), np.int32)
        self._n = 0
        self.add(root, -1)

    def __len__(self) -> int:
        return self._n

    def state(self, i: int) -> np.ndarray:
        return self._states[i]

    def add(self, q: np.ndarray, parent: int) -> int:
        if self._n == self._states.shape[0]:
            self._states = np.concatenate([self._states, np.empty_like(self._states)])
            self._parent = np.concatenate([self._parent, np.empty_like(self._parent)])
        self._states[self._n] = q
        self._parent[self._n] = parent
        self._n += 1
        return self._n - 1

    def nearest(self, q: np.ndarray) -> int:
        d = np.max(np.abs(self._states[: self._n] - q[None, :]), axis=1)
        return int(np.argmin(d))

    def trace(self, i: int) -> List[np.ndarray]:
        out = []
        while i >= 0:
            out.append(self._states[i].copy())
            i = int(self._parent[i])
        out.reverse()
        return out


class RRTConnect:
    """Bidirectional RRT with greedy connect (Kuffner & LaValle 2000) over a
    `MotionValidator` — fills the og::Planner role of the reference app
    (gvl_ompl_planner.cpp:103-124) with segment validation batched on device.

    `step` bounds each tree extension in the max-abs metric; `connect`
    extensions repeat until the target is reached or a segment collides;
    each extension costs one batched device program and one fetch.
    """

    def __init__(
        self,
        space: JointSpace,
        validator: MotionValidator,
        step: float = 0.5,
        seed: int = 0,
    ):
        self.space = space
        self.validator = validator
        self.step = float(step)
        self.rng = np.random.default_rng(seed)
        self.motion_checks = 0
        self.states_checked = 0

    # -- internals ---------------------------------------------------------
    def _check(self, a: np.ndarray, b: np.ndarray) -> bool:
        ok, n = self.validator.check_motion(a, b)
        self.motion_checks += 1
        self.states_checked += n
        return ok

    def _steer(self, a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, bool]:
        """One bounded step from a toward b; returns (state, reached_b)."""
        d = self.space.distance(a, b)
        if d <= self.step:
            return b, True
        return a + (b - a) * (self.step / d), False

    def _extend(self, tree: _Tree, q: np.ndarray) -> Tuple[int, bool]:
        """EXTEND: one step from the nearest node toward q.
        Returns (new node id or -1, reached q)."""
        i = tree.nearest(q)
        qn, reached = self._steer(tree.state(i), q)
        if not self._check(tree.state(i), qn):
            return -1, False
        return tree.add(qn, i), reached

    def _connect(self, tree: _Tree, q: np.ndarray) -> int:
        """CONNECT: greedy repeated extension toward q; node id on reach, -1
        on a blocked segment."""
        while True:
            i, reached = self._extend(tree, q)
            if i < 0:
                return -1
            if reached:
                return i

    # -- public ------------------------------------------------------------
    def solve(
        self,
        start,
        goal,
        max_iters: int = 2000,
        time_budget: Optional[float] = None,
    ) -> PlannerResult:
        """ob::Planner::solve equivalent (the reference budgets 20 s,
        gvl_ompl_planner.cpp:122; here iteration-bounded by default with an
        optional wall budget). Start/goal are validated first — an invalid
        endpoint fails immediately like OMPL's precondition check."""
        t0 = time.monotonic()
        self.motion_checks = 0
        self.states_checked = 0
        start = np.asarray(start, np.float32)
        goal = np.asarray(goal, np.float32)
        if not (self.space.contains(start) and self.space.contains(goal)):
            raise ValueError("start/goal outside the joint space bounds")

        def _done(path: Optional[Path], iters: int) -> PlannerResult:
            return PlannerResult(
                path, iters, self.motion_checks, self.states_checked,
                time.monotonic() - t0,
            )

        checker = self.validator.checker
        if not (checker.is_valid(start) and checker.is_valid(goal)):
            return _done(None, 0)
        if self._check(start, goal):  # trivial: straight segment is free
            return _done(Path(np.stack([start, goal])), 0)

        ta, tb = _Tree(start), _Tree(goal)
        a_is_start = True
        for it in range(1, max_iters + 1):
            if time_budget is not None and time.monotonic() - t0 > time_budget:
                break
            q = self.space.sample(self.rng)
            ia, _ = self._extend(ta, q)
            if ia >= 0:
                ib = self._connect(tb, ta.state(ia))
                if ib >= 0:  # trees met at ta.state(ia)
                    seg_a = ta.trace(ia)
                    seg_b = tb.trace(ib)
                    if not a_is_start:
                        seg_a, seg_b = seg_b, seg_a
                    # seg_a runs start->meet, seg_b goal->meet: reverse b,
                    # drop its duplicated meeting state
                    states = np.stack(seg_a + seg_b[::-1][1:])
                    return _done(Path(states), it)
            ta, tb = tb, ta
            a_is_start = not a_is_start
        return _done(None, max_iters)


class PathSimplifier:
    """og::PathSimplifier::simplifyMax essentials
    (gvl_ompl_planner.cpp:70,137): randomized shortcutting + greedy vertex
    reduction, every candidate shortcut validated as one batched segment."""

    def __init__(self, validator: MotionValidator, seed: int = 0):
        self.validator = validator
        self.rng = np.random.default_rng(seed)

    def _check(self, a, b) -> bool:
        ok, _ = self.validator.check_motion(a, b)
        return ok

    def reduce_vertices(self, path: Path, max_rounds: int = 8) -> Path:
        """Greedy: drop any interior vertex whose neighbors connect
        directly; repeat until a fixpoint (or max_rounds)."""
        states = [s for s in path.states]
        for _ in range(max_rounds):
            changed = False
            i = 0
            while i + 2 < len(states):
                if self._check(states[i], states[i + 2]):
                    del states[i + 1]
                    changed = True
                else:
                    i += 1
            if not changed:
                break
        return Path(np.stack(states))

    def shortcut(self, path: Path, attempts: int = 32) -> Path:
        """Randomized shortcut: connect two random points on the path
        (interior of segments included) and splice when collision-free."""
        states = [s for s in path.states]
        for _ in range(attempts):
            if len(states) < 3:
                break
            # pick two distinct segments and a point inside each
            i, j = sorted(self.rng.choice(len(states) - 1, size=2, replace=False))
            ti = self.rng.uniform()
            tj = self.rng.uniform()
            pi = states[i] * (1 - ti) + states[i + 1] * ti
            pj = states[j] * (1 - tj) + states[j + 1] * tj
            if self._check(pi, pj):
                states = states[: i + 1] + [pi, pj] + states[j + 1:]
        return Path(np.stack(states))

    def simplify(self, path: Path, shortcut_attempts: int = 32) -> Path:
        out = self.shortcut(path, shortcut_attempts)
        return self.reduce_vertices(out)
