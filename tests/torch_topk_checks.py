"""Comparison of two top-k answers under the rule the port's tests hold the KNN scorer to.

Both sides score with bf16-rounded inputs, but round the dot product at different places (XLA on
the CPU keeps the f32 accumulator under jit; the port rounds the product to bf16 as the program's
types say). So scores agree within one bf16 ulp of the dot, and ids agree wherever a score is
clear of its neighbours by more than that.
"""

from __future__ import annotations

import numpy as np


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    x = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(x)) - 7)


def assert_topk_equal(s_ours, i_ours, s_theirs, i_theirs, tol) -> int:
    """Ours ``[q, k]`` against theirs ``[q, k + 1]`` (one more, so that the k-th score's gap to
    the next is known; ``[q, k]`` when k is every row). Scores within ``tol``; ids equal where
    the score is clear of its neighbours by more than ``tol``, where scores are -inf, and for a
    pair that ties exactly on their side (duplicated rows) and is clear of its neighbours; equal
    scores lower id first."""
    s_ours, i_ours = np.asarray(s_ours), np.asarray(i_ours)
    s_theirs, i_theirs = np.asarray(s_theirs), np.asarray(i_theirs)
    k = s_ours.shape[1]
    assert i_ours.shape == s_ours.shape and s_theirs.shape[1] in (k, k + 1)
    tol = np.broadcast_to(tol, s_theirs.shape)[:, :k]
    if s_theirs.shape[1] == k:
        s_theirs = np.concatenate([s_theirs, np.full((len(s_theirs), 1), -np.inf)], axis=1)
    nxt, s_theirs, i_theirs = s_theirs[:, 1:], s_theirs[:, :k], i_theirs[:, :k]
    fin = np.isfinite(s_theirs)
    np.testing.assert_array_equal(np.isfinite(s_ours), fin)
    assert (np.abs(s_ours[fin] - s_theirs[fin]) <= tol[fin]).all()
    with np.errstate(invalid="ignore"):  # -inf minus -inf
        gap_prev = np.concatenate(
            [np.full((len(s_theirs), 1), np.inf), s_theirs[:, :-1] - s_theirs[:, 1:]], axis=1)
        clear = (gap_prev > tol) & (s_theirs - nxt > tol)
    np.testing.assert_array_equal(i_ours[clear], i_theirs[clear])
    np.testing.assert_array_equal(i_ours[~fin], i_theirs[~fin])  # -inf ties: lower row first
    ties = s_ours[:, 1:] == s_ours[:, :-1]
    assert (i_ours[:, 1:][ties] > i_ours[:, :-1][ties]).all()
    with np.errstate(invalid="ignore"):
        pair = ((s_theirs[:, 1:] == s_theirs[:, :-1]) & (gap_prev[:, :-1] > tol[:, :-1])
                & ((s_theirs - nxt)[:, 1:] > tol[:, 1:]))
    np.testing.assert_array_equal(i_ours[:, 1:][pair], i_theirs[:, 1:][pair])
    np.testing.assert_array_equal(i_ours[:, :-1][pair], i_theirs[:, :-1][pair])
    return int(pair.sum())


def topk_tol(scores: np.ndarray, queries: np.ndarray, index: np.ndarray,
             metric: str) -> np.ndarray:
    """One bf16 ulp of the score (cos, ip); for l2, two ulps of the largest possible dot."""
    if metric in ("cos", "ip"):
        return bf16_ulp(scores)
    dot_max = np.linalg.norm(queries, axis=1, keepdims=True) * np.linalg.norm(index, axis=1).max()
    return np.broadcast_to(2 * bf16_ulp(dot_max) + 1e-6 * np.abs(scores), scores.shape)


def assert_docs_close(got: list, want: list) -> None:
    """Two ``DocumentStore`` answers (lists of {text, metadata, dist}, best first): the same
    length, each ``dist`` within one bf16 ulp of the reference's, and text and metadata equal
    wherever the reference's dist is clear of its neighbours' by more than two ulps."""
    assert len(got) == len(want), (got, want)
    dists = np.array([float(w["dist"]) for w in want])
    tol = bf16_ulp(dists)
    for g, w, t in zip(got, want, tol):
        assert abs(float(g["dist"]) - float(w["dist"])) <= t, (g, w)
    for i, (g, w) in enumerate(zip(got, want)):
        near = [abs(dists[i] - dists[j]) <= 2 * tol[i] for j in (i - 1, i + 1)
                if 0 <= j < len(want)]
        if not any(near):
            assert (g["text"], g["metadata"]) == (w["text"], w["metadata"]), (i, got, want)
