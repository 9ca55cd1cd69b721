"""Graph placement on the 2D array — the paper's branch-and-bound search.

Each layer graph G_i is a rectangle of ``cas_len`` columns x ``cas_num`` rows.
Given the execution order G_0..G_{n-1}, we choose lower-left corners to
minimize the weighted cost (paper Eq. 2):

    J = sum_i ( |c_out^i - c_in^{i+1}| + lam*|r_out^i - r_in^{i+1}|
                + mu*r_top^i )

Port convention (Sec. III-B/C): inputs are broadcast up the *leftmost* column
of a block from the memory-tile row (c_in = col, r_in = row); the cascade
exits the *rightmost* column (c_out = col + w - 1, r_out = row). r_top biases
the layout toward the lower rows where the memory tiles aggregate.

The solver is an exact branch-and-bound: depth-first over graphs in order,
candidates at each level sorted by (incremental cost + admissible lower
bound), pruning any partial assignment that cannot beat the incumbent. A
candidate ``beam`` cap bounds the per-level branching for very large
instances (None = exact); tests verify exact mode against brute force.

A copy of ``repro.core.placement``: the port's Place pass must give the
reference's placements and costs.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.ir import PlacementSpec


@dataclasses.dataclass(frozen=True)
class Block:
    """A placeable layer graph: width=cas_len, height=cas_num."""

    width: int
    height: int
    name: str = ""


@dataclasses.dataclass
class PlacementResult:
    positions: List[PlacementSpec]
    cost: float
    nodes_expanded: int = 0
    method: str = "bnb"

    def as_tuples(self) -> List[Tuple[int, int]]:
        return [(p.col, p.row) for p in self.positions]


def _overlaps(a: PlacementSpec, b: PlacementSpec) -> bool:
    return not (
        a.col + a.width <= b.col
        or b.col + b.width <= a.col
        or a.row + a.height <= b.row
        or b.row + b.height <= a.row
    )


def _pair_cost(prev: PlacementSpec, nxt: PlacementSpec, lam: float) -> float:
    return abs(prev.c_out - nxt.c_in) + lam * abs(prev.r_out - nxt.r_in)


def placement_cost(
    positions: Sequence[PlacementSpec], lam: float = 1.0, mu: float = 0.05
) -> float:
    """Evaluate Eq. 2 for a full placement."""
    j = 0.0
    for i, p in enumerate(positions):
        j += mu * p.r_top
        if i + 1 < len(positions):
            j += _pair_cost(p, positions[i + 1], lam)
    return j


class Placer:
    def __init__(
        self,
        n_cols: int,
        n_rows: int,
        lam: float = 1.0,
        mu: float = 0.05,
        beam: Optional[int] = 64,
        max_expansions: Optional[int] = 500_000,
    ):
        self.n_cols = n_cols
        self.n_rows = n_rows
        self.lam = lam
        self.mu = mu
        self.beam = beam
        # anytime budget: when exceeded, return the best incumbent so far
        # (candidate ordering means the first descent is already greedy-good)
        self.max_expansions = max_expansions

    # -- candidate generation ------------------------------------------------

    def _feasible_positions(
        self, block: Block, placed: List[PlacementSpec]
    ) -> List[PlacementSpec]:
        out = []
        for c in range(self.n_cols - block.width + 1):
            for r in range(self.n_rows - block.height + 1):
                cand = PlacementSpec(c, r, block.width, block.height)
                if all(not _overlaps(cand, p) for p in placed):
                    out.append(cand)
        return out

    # -- exact / beam branch-and-bound ----------------------------------------

    def branch_and_bound(
        self,
        blocks: Sequence[Block],
        start: Optional[Tuple[int, int]] = None,
        fixed: Optional[Dict[int, Tuple[int, int]]] = None,
    ) -> PlacementResult:
        """Minimize Eq. 2. ``fixed`` pins block i at (col, row) as a hard
        constraint (user overrides); ``start`` pins block 0."""
        blocks = list(blocks)
        fixed = dict(fixed or {})
        if start is not None:
            fixed[0] = start
        for i, b in enumerate(blocks):
            if b.width > self.n_cols or b.height > self.n_rows:
                raise ValueError(f"block {i} ({b.width}x{b.height}) exceeds array")

        # Admissible lower bound for the unplaced suffix: each remaining
        # block contributes at least mu*(h-1) (best case: row 0), pairwise
        # terms are >= 0.
        suffix_lb = [0.0] * (len(blocks) + 1)
        for i in range(len(blocks) - 1, -1, -1):
            suffix_lb[i] = suffix_lb[i + 1] + self.mu * (blocks[i].height - 1)

        best_cost = float("inf")
        best: Optional[List[PlacementSpec]] = None
        stats = {"expanded": 0}

        class _Budget(Exception):
            pass

        def dfs(i: int, placed: List[PlacementSpec], cost: float):
            nonlocal best_cost, best
            if (self.max_expansions is not None
                    and stats["expanded"] > self.max_expansions
                    and best is not None):
                raise _Budget
            if cost + suffix_lb[i] >= best_cost:
                return
            if i == len(blocks):
                best_cost, best = cost, list(placed)
                return
            if i in fixed:
                c, r = fixed[i]
                if (c + blocks[i].width > self.n_cols
                        or r + blocks[i].height > self.n_rows
                        or c < 0 or r < 0):
                    raise ValueError(
                        f"fixed placement for block {i} is out of bounds")
                cands = [PlacementSpec(c, r, blocks[i].width,
                                       blocks[i].height)]
                if any(_overlaps(cands[0], p) for p in placed):
                    return  # conflicts with this partial assignment: backtrack
            else:
                cands = self._feasible_positions(blocks[i], placed)

            def inc(cand: PlacementSpec) -> float:
                d = self.mu * cand.r_top
                if placed:
                    d += _pair_cost(placed[-1], cand, self.lam)
                return d

            cands.sort(key=inc)
            if self.beam is not None and i not in fixed:
                cands = cands[: self.beam]
            for cand in cands:
                stats["expanded"] += 1
                d = inc(cand)
                if cost + d + suffix_lb[i + 1] >= best_cost:
                    # candidates are sorted by incremental cost, but the
                    # suffix bound is constant here, so all later cands
                    # prune too.
                    break
                placed.append(cand)
                dfs(i + 1, placed, cost + d)
                placed.pop()

        try:
            dfs(0, [], 0.0)
        except _Budget:
            pass  # anytime: fall through with the incumbent
        if best is None:
            raise ValueError("no feasible placement found")
        return PlacementResult(best, best_cost, stats["expanded"], "bnb")

    # -- greedy baselines (paper Fig. 3 b, c) ---------------------------------

    def _greedy(self, blocks: Sequence[Block], primary: str,
                start: Tuple[int, int] = (0, 0)) -> PlacementResult:
        placed: List[PlacementSpec] = []
        cur = start
        for i, b in enumerate(blocks):
            cand = None
            if i == 0:
                cand = PlacementSpec(start[0], start[1], b.width, b.height)
                if any(_overlaps(cand, p) for p in placed):
                    cand = None
            else:
                prev = placed[-1]
                if primary == "right":
                    order = [
                        (prev.col + prev.width, prev.row),
                        (prev.col, prev.row + prev.height),
                    ]
                else:  # "up"
                    order = [
                        (prev.col, prev.row + prev.height),
                        (prev.col + prev.width, prev.row),
                    ]
                for c, r in order:
                    t = PlacementSpec(c, r, b.width, b.height)
                    if (
                        c + b.width <= self.n_cols
                        and r + b.height <= self.n_rows
                        and all(not _overlaps(t, p) for p in placed)
                    ):
                        cand = t
                        break
            if cand is None:
                # fall back: first feasible position (row-major scan)
                feas = self._feasible_positions(b, placed)
                if not feas:
                    raise ValueError(f"greedy-{primary}: no feasible slot for {i}")
                cand = feas[0]
            placed.append(cand)
            cur = (cand.col, cand.row)
        return PlacementResult(
            placed, placement_cost(placed, self.lam, self.mu), 0, f"greedy_{primary}"
        )

    def greedy_right(self, blocks, start=(0, 0)) -> PlacementResult:
        return self._greedy(blocks, "right", start)

    def greedy_up(self, blocks, start=(0, 0)) -> PlacementResult:
        return self._greedy(blocks, "up", start)

    # -- exhaustive reference (tests only) ------------------------------------

    def brute_force(
        self, blocks: Sequence[Block], start: Optional[Tuple[int, int]] = None
    ) -> PlacementResult:
        blocks = list(blocks)
        best_cost, best = float("inf"), None
        all_pos = [
            self._feasible_positions(b, []) for b in blocks
        ]
        if start is not None:
            all_pos[0] = [
                p for p in all_pos[0] if (p.col, p.row) == start
            ]
        for combo in itertools.product(*all_pos):
            ok = True
            for a, b in itertools.combinations(combo, 2):
                if _overlaps(a, b):
                    ok = False
                    break
            if not ok:
                continue
            c = placement_cost(combo, self.lam, self.mu)
            if c < best_cost:
                best_cost, best = c, list(combo)
        if best is None:
            raise ValueError("no feasible placement")
        return PlacementResult(best, best_cost, 0, "brute")
