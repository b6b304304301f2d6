"""Fuzzy joins (reference
``python/pathway/stdlib/ml/smart_table_ops/_fuzzy_join.py``:
``fuzzy_match`` :265, ``fuzzy_self_match`` :249, ``fuzzy_match_tables``
:106, ``smart_fuzzy_match`` :199, ``fuzzy_match_with_hint`` :282).

Own construction, same contract: tokenize both sides into features,
weight features by inverse global frequency, score candidate pairs by
shared-feature weight, and keep mutually-best pairs. Everything is
ordinary incremental dataflow (flatten + join + groupby), so matches
update live as either side changes.

Copy of ``pathway_tpu/stdlib/ml/smart_table_ops.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

import enum
import math
import re
from typing import Any, Callable

from ... import reducers
from ...internals import dtype as dt
from ...internals.expression import ColumnReference, apply_with_type
from ...internals.table import Table
from ...internals.thisclass import left as l_, right as r_, this

__all__ = [
    "FuzzyJoinFeatureGeneration",
    "FuzzyJoinNormalization",
    "fuzzy_match",
    "fuzzy_self_match",
    "fuzzy_match_tables",
    "smart_fuzzy_match",
    "fuzzy_match_with_hint",
]


class FuzzyJoinFeatureGeneration(enum.IntEnum):
    AUTO = 0
    TOKENIZE = 1
    LETTERS = 2


class FuzzyJoinNormalization(enum.IntEnum):
    WEIGHT = 0
    LOGWEIGHT = 1
    NONE = 2


def _features(value: Any, generation: FuzzyJoinFeatureGeneration) -> tuple[str, ...]:
    text = str(value).lower()
    if generation == FuzzyJoinFeatureGeneration.LETTERS:
        return tuple(ch for ch in text if not ch.isspace())
    return tuple(re.findall(r"\w+", text))


def _edges(
    column: ColumnReference,
    generation: FuzzyJoinFeatureGeneration,
    side: str,
) -> Table:
    """(node_id, feature) rows — one per (row, distinct feature)."""
    table = column.table
    flat = table.select(
        __feats=apply_with_type(
            lambda v: tuple(set(_features(v, generation))), dt.ANY, column
        ),
    ).flatten(this["__feats"], origin_id="__node")
    return flat.select(
        feature=this["__feats"],
        node=this["__node"],
    )


def _normalizer(normalization: FuzzyJoinNormalization) -> Callable[[float], float]:
    if normalization == FuzzyJoinNormalization.WEIGHT:
        return lambda cnt: 1.0 / cnt
    if normalization == FuzzyJoinNormalization.LOGWEIGHT:
        return lambda cnt: 1.0 / (1.0 + math.log(cnt))
    return lambda cnt: 1.0


def fuzzy_match(
    left_col: ColumnReference,
    right_col: ColumnReference,
    *,
    feature_generation: FuzzyJoinFeatureGeneration = FuzzyJoinFeatureGeneration.TOKENIZE,
    normalization: FuzzyJoinNormalization = FuzzyJoinNormalization.WEIGHT,
) -> Table:
    """Table(left, right, weight): mutually-best fuzzy pairs between the
    two text columns (reference _fuzzy_join.py:265)."""
    left_edges = _edges(left_col, feature_generation, "l")
    right_edges = _edges(right_col, feature_generation, "r")

    # global feature frequency (both sides) -> weight
    all_edges = left_edges.concat_reindex(right_edges)
    counts = all_edges.groupby(this.feature).reduce(
        feature=this.feature, cnt=reducers.count()
    )
    norm = _normalizer(normalization)
    weights = counts.select(
        feature=this.feature,
        weight=apply_with_type(lambda c: norm(float(c)), dt.FLOAT, this.cnt),
    )

    # candidate pairs sharing a feature, scored by summed feature weight
    pairs = (
        left_edges.join(right_edges, l_.feature == r_.feature)
        .select(feature=l_.feature, left=l_.node, right=r_.node)
    )
    pairs_w = (
        pairs.join(weights, l_.feature == r_.feature)
        .select(left=l_.left, right=l_.right, weight=r_.weight)
    )
    scored = pairs_w.groupby(this.left, this.right).reduce(
        left=this.left, right=this.right, weight=reducers.sum(this.weight)
    )

    # mutually-best: the heaviest pair for its left AND for its right
    best_left = scored.groupby(this.left).reduce(
        left=this.left,
        best=reducers.argmax(this.weight),
    )
    best_right = scored.groupby(this.right).reduce(
        right=this.right,
        best=reducers.argmax(this.weight),
    )
    # argmax values ARE keys of `scored`, so both reindexed winner tables
    # are subsets of it by construction — promised, since the solver can't
    # prove it across the reindex. A best-for-right row need NOT be
    # best-for-left, so the second cut is an intersection, not a restrict.
    keep_l = scored.restrict(
        best_left.with_id(this.best).promise_universe_is_subset_of(scored)
    )
    mutual = keep_l.intersect(
        best_right.with_id(this.best).promise_universe_is_subset_of(scored)
    )
    return mutual


def fuzzy_self_match(
    values: ColumnReference,
    **kwargs: Any,
) -> Table:
    """Fuzzy pairs within one column, excluding self-pairs
    (reference :249)."""
    matched = fuzzy_match(values, values, **kwargs)
    return matched.filter(
        apply_with_type(
            lambda a, b: a != b, dt.BOOL, this.left, this.right
        )
    )


def _concat_row_text(table: Table) -> Table:
    cols = [table[c] for c in table.column_names()]
    return table.select(
        __text=apply_with_type(
            lambda *vs: " ".join(str(v) for v in vs if v is not None),
            dt.STR, *cols,
        )
    )


def fuzzy_match_tables(
    left_table: Table,
    right_table: Table,
    *,
    by_hand_match: Table | None = None,
    left_projection: dict[str, str] | None = None,
    right_projection: dict[str, str] | None = None,
    **kwargs: Any,
) -> Table:
    """Fuzzy-match whole rows (all columns concatenated to text,
    reference :106)."""
    lcols = list(left_projection) if left_projection else left_table.column_names()
    rcols = list(right_projection) if right_projection else right_table.column_names()
    lt = _concat_row_text(left_table.select(**{c: left_table[c] for c in lcols}))
    rt = _concat_row_text(right_table.select(**{c: right_table[c] for c in rcols}))
    matched = fuzzy_match(
        ColumnReference(lt, "__text"), ColumnReference(rt, "__text"), **kwargs
    )
    if by_hand_match is not None:
        # hand matches override: drop computed pairs whose left appears
        hand_lefts = by_hand_match.with_id(this.left)
        matched = matched.with_id(this.left).difference(hand_lefts).concat_reindex(
            by_hand_match
        )
    return matched


def smart_fuzzy_match(
    left_col: ColumnReference,
    right_col: ColumnReference,
    **kwargs: Any,
) -> Table:
    """reference :199 — fuzzy_match with the default heuristics."""
    kwargs.setdefault("normalization", FuzzyJoinNormalization.LOGWEIGHT)
    return fuzzy_match(left_col, right_col, **kwargs)


def fuzzy_match_with_hint(
    left_col: ColumnReference,
    right_col: ColumnReference,
    by_hand_match: Table,
    **kwargs: Any,
) -> Table:
    """reference :282 — hand-made (left, right, weight) rows override the
    computed matching for their left keys."""
    matched = fuzzy_match(left_col, right_col, **kwargs)
    hand_keyed = by_hand_match.with_id(this.left)
    auto_keyed = matched.with_id(this.left)
    return auto_keyed.difference(hand_keyed).concat_reindex(by_hand_match)
