"""Universe solver — propositional reasoning over key-set relations.

Re-design of the reference's SAT-based solver
(``python/pathway/internals/universe_solver.py``): each universe is a
propositional variable ("an arbitrary fixed key is in this set"); subset is
the implication clause ¬A∨B, disjointness ¬A∨¬B, union/intersection/
difference add their defining clauses; a query holds iff its negation is
unsatisfiable (``query_is_subset(A,B)`` ⇔ {A, ¬B} UNSAT). The reference
delegates to python-sat; this environment has no SAT library, so a small
DPLL solver with unit propagation lives here — the clause databases involved
(a few variables per Table operation) are tiny.
"""

from __future__ import annotations

from typing import Any, Iterable

__all__ = ["UniverseSolver"]


class UniverseSolver:
    def __init__(self) -> None:
        self._vars: dict[Any, int] = {}  # universe -> positive literal
        self.clauses: list[tuple[int, ...]] = []
        #: clauses derivable from table structure alone (no user promises):
        #: proofs over these need no runtime re-verification
        self.structural_clauses: list[tuple[int, ...]] = []
        self._query_cache: dict[tuple, bool] = {}

    # -- variables / clauses ----------------------------------------------

    def var(self, universe: Any) -> int:
        v = self._vars.get(universe)
        if v is None:
            v = len(self._vars) + 1
            self._vars[universe] = v
        return v

    def add_clause(self, lits: Iterable[int], *, promised: bool = False) -> None:
        clause = tuple(lits)
        self.clauses.append(clause)
        if not promised:
            self.structural_clauses.append(clause)
        self._query_cache.clear()

    # -- registration (reference universe_solver.py API) -------------------

    def register_as_subset(self, subset: Any, superset: Any,
                           *, promised: bool = False) -> None:
        a, b = self.var(subset), self.var(superset)
        self.add_clause([-a, b], promised=promised)  # A => B

    def register_as_equal(self, left: Any, right: Any,
                          *, promised: bool = False) -> None:
        self.register_as_subset(left, right, promised=promised)
        self.register_as_subset(right, left, promised=promised)

    def register_as_disjoint(self, *args: Any, promised: bool = False) -> None:
        vs = [self.var(a) for a in args]
        for i in range(len(vs)):
            for j in range(i):
                self.add_clause([-vs[i], -vs[j]], promised=promised)  # Ai => ¬Aj

    def register_as_difference(self, result: Any, left: Any, right: Any) -> None:
        """result = left - right."""
        self.register_as_subset(result, left)
        self.register_as_disjoint(result, right)
        r, a, b = self.var(result), self.var(left), self.var(right)
        self.add_clause([r, -a, b])  # (A ∧ ¬B) => R

    def register_as_intersection(self, result: Any, *args: Any) -> None:
        for arg in args:
            self.register_as_subset(result, arg)
        r = self.var(result)
        vs = [self.var(a) for a in args]
        self.add_clause([r, *[-v for v in vs]])  # (A1 ∧ A2 ∧ …) => R

    def register_as_union(self, result: Any, *args: Any) -> None:
        for arg in args:
            self.register_as_subset(arg, result)
        r = self.var(result)
        vs = [self.var(a) for a in args]
        self.add_clause([-r, *vs])  # R => (A1 ∨ A2 ∨ …)

    # -- queries -----------------------------------------------------------

    def query_is_subset(self, subset: Any, superset: Any) -> bool:
        key = ("sub", self.var(subset), self.var(superset))
        hit = self._query_cache.get(key)
        if hit is None:
            # A ⊆ B ⇔ {A, ¬B} unsatisfiable
            hit = not self._solve((key[1], -key[2]))
            self._query_cache[key] = hit
        return hit

    def query_are_equal(self, a: Any, b: Any) -> bool:
        return self.query_is_subset(a, b) and self.query_is_subset(b, a)

    def query_are_disjoint(self, *args: Any, structural_only: bool = False) -> bool:
        """``structural_only=True`` ignores promise clauses: a True result
        is then a *proof* (no runtime verification needed), not trust."""
        vs = [self.var(a) for a in args]
        for i in range(len(vs)):
            for j in range(i):
                key = ("dis", structural_only, *sorted((vs[i], vs[j])))
                hit = self._query_cache.get(key)
                if hit is None:
                    hit = not self._solve(
                        (vs[i], vs[j]), structural_only=structural_only
                    )
                    self._query_cache[key] = hit
                if not hit:
                    return False
        return True

    def query_is_empty(self, a: Any) -> bool:
        return not self._solve((self.var(a),))

    # -- the DPLL core ------------------------------------------------------

    def _solve(
        self, assumptions: tuple[int, ...], *, structural_only: bool = False
    ) -> bool:
        """Satisfiability of the clause DB under the given literal
        assumptions. DPLL: unit-propagate, then split on a variable of the
        first unresolved clause."""
        assign: dict[int, bool] = {}
        for lit in assumptions:
            val = lit > 0
            if assign.setdefault(abs(lit), val) != val:
                return False
        db = self.structural_clauses if structural_only else self.clauses
        return self._dpll(db, assign)

    def _dpll(self, clauses: list[tuple[int, ...]], assign: dict[int, bool]) -> bool:
        while True:
            unit: int | None = None
            pending: list[tuple[int, ...]] = []
            for clause in clauses:
                satisfied = False
                unassigned: list[int] = []
                for lit in clause:
                    val = assign.get(abs(lit))
                    if val is None:
                        unassigned.append(lit)
                    elif (lit > 0) == val:
                        satisfied = True
                        break
                if satisfied:
                    continue
                if not unassigned:
                    return False  # conflict
                if len(unassigned) == 1 and unit is None:
                    unit = unassigned[0]
                pending.append(clause)
            if unit is not None:
                assign[abs(unit)] = unit > 0
                clauses = pending
                continue
            if not pending:
                return True  # every clause satisfied
            # split on the first unassigned literal of the first open clause
            for lit in pending[0]:
                if abs(lit) not in assign:
                    branch = abs(lit)
                    break
            for val in (True, False):
                trial = dict(assign)
                trial[branch] = val
                if self._dpll(pending, trial):
                    return True
            return False
