"""External-index engine operator: live index maintenance + query answering.

Re-design of the reference's ``UseExternalIndexAsOfNow`` timely operator
(``src/engine/dataflow/operators/external_index.rs:38``) and the native index
engines behind it (``src/external_integration/``). The vector scoring runs on
the card: ``ops/index_engines.py``'s ``BruteForceKnnEngine`` scores with the
``knn_topk`` kernel and embeds text with the encoder.

Besides the reference's as-of-now semantics this node also supports
*maintained* semantics: when the indexed data changes, every stored query is
re-answered and the node emits retract/insert diffs for answers that changed.

The node's contract: input 0 is the indexed-data stream (columns
``__data__`` and optionally ``__filter_data__``), input 1 the query stream
(``__query__``, ``__limit__``, optionally ``__filter__``). Output is keyed
by query key with one column ``_pw_index_reply`` holding a tuple of
``(matched_key, score)`` pairs, best first. Under a sharded run both inputs
gather to worker 0, which holds the index.

Copy of ``pathway_tpu/engine/external_index.py`` without the scale-out
serving branch (``PATHWAY_SERVE_SHARDED``), which waits for the serve plane.
A restored node grafts the freshly built engine's embedder onto the engine it
unpickled; the engine rebuilds its device mirror on the first search.
"""

from __future__ import annotations

from typing import Any, Protocol

import numpy as np

from .delta import Delta
from .executor import Node

__all__ = ["IndexEngine", "ExternalIndexNode", "REPLY_COLUMN"]

REPLY_COLUMN = "_pw_index_reply"


class IndexEngine(Protocol):
    """Host-side mutable index; scoring may run on the device."""

    def add(self, key: int, data: Any, filter_data: Any) -> None: ...

    def remove(self, key: int) -> None: ...

    def search(
        self, queries: list[Any], limits: list[int], filters: list[Any]
    ) -> list[list[tuple[int, float]]]:
        """For each query: [(key, score), ...] best-first, honoring filters."""
        ...


class ExternalIndexNode(Node):
    # the engine (host arenas; the engines' __getstate__ drops the device
    # mirror and the embedder) snapshots alongside the standing queries
    STATE_FIELDS = ("engine", "_queries", "_answered")

    # gather-routed: the whole index lives on worker 0 under any layout,
    # so a rescale keeps worker 0's piece (rescale/resharder.py)
    RESHARD = "pinned"

    def restore_state(self, state: dict) -> None:
        fresh = self.engine
        super().restore_state(state)
        # non-picklable config (embedder closures) carries over from the
        # freshly-built engine — see BruteForceKnnEngine.__getstate__
        if getattr(self.engine, "embedder", None) is None:
            self.engine.embedder = getattr(fresh, "embedder", None)

    def __init__(self, data_node: Node, query_node: Node, engine: IndexEngine,
                 *, asof_now: bool):
        super().__init__([data_node, query_node], [REPLY_COLUMN])
        self.engine = engine
        self.asof_now = asof_now
        # query key -> (data, limit, filter, last_reply)
        self._queries: dict[int, list[Any]] = {}
        # asof-now mode still must retract answers when the *query* retracts
        self._answered: dict[int, tuple] = {}

    def exchange_specs(self):
        # the index lives on worker 0 (sharded index variants live at the
        # ops layer: ops/knn.py sharded_knn_search with all-gather merge)
        return [("gather",), ("gather",)]

    def process(self, time: int, in_deltas: list[Delta | None]) -> Delta | None:
        data_d, query_d = in_deltas
        index_changed = False
        if data_d is not None and len(data_d):
            self._apply_data(data_d)
            index_changed = True

        out_keys: list[int] = []
        out_replies: list[tuple] = []
        out_diffs: list[int] = []

        new_qkeys: list[int] = []
        if query_d is not None and len(query_d):
            qcols = query_d.data
            qdatas = qcols["__query__"]
            qlimits = qcols.get("__limit__")
            qfilters = qcols.get("__filter__")
            # retractions first: an in-tick update may carry (+new, -old) in
            # either order and must land as the new query
            qorder = np.argsort(query_d.diffs, kind="stable")
            for i in qorder:
                k = int(query_d.keys[i])
                q = qdatas[i]
                lim = int(qlimits[i]) if qlimits is not None else 3
                flt = qfilters[i] if qfilters is not None else None
                if query_d.diffs[i] > 0:
                    self._queries[k] = [q, lim, flt, None]
                    new_qkeys.append(k)
                else:
                    self._queries.pop(k, None)
                    prev = self._answered.pop(k, None)
                    if prev is not None:
                        out_keys.append(k)
                        out_replies.append(prev)
                        out_diffs.append(-1)

        # answer new queries against the current index state
        if new_qkeys:
            entries = [self._queries[k] for k in new_qkeys]
            replies = self.engine.search(
                [e[0] for e in entries], [e[1] for e in entries],
                [e[2] for e in entries],
            )
            for k, rep in zip(new_qkeys, replies):
                reply = tuple((int(mk), float(s)) for mk, s in rep)
                out_keys.append(k)
                out_replies.append(reply)
                out_diffs.append(1)
                self._answered[k] = reply
                if not self.asof_now:
                    self._queries[k][3] = reply
            if self.asof_now:
                for k in new_qkeys:
                    self._queries.pop(k, None)

        # maintained semantics: index changed → re-answer standing queries
        if index_changed and not self.asof_now and self._queries:
            fresh = set(new_qkeys)
            standing = [k for k in self._queries if k not in fresh]
            if standing:
                entries = [self._queries[k] for k in standing]
                replies = self.engine.search(
                    [e[0] for e in entries], [e[1] for e in entries],
                    [e[2] for e in entries],
                )
                for k, rep in zip(standing, replies):
                    reply = tuple((int(mk), float(s)) for mk, s in rep)
                    prev = self._queries[k][3]
                    if prev == reply:
                        continue
                    if prev is not None:
                        out_keys.append(k)
                        out_replies.append(prev)
                        out_diffs.append(-1)
                    out_keys.append(k)
                    out_replies.append(reply)
                    out_diffs.append(1)
                    self._queries[k][3] = reply
                    self._answered[k] = reply

        if not out_keys:
            return None
        data = np.empty(len(out_replies), dtype=object)
        for i, r in enumerate(out_replies):
            data[i] = r
        return Delta(
            keys=np.array(out_keys, dtype=np.uint64),
            data={REPLY_COLUMN: data},
            diffs=np.array(out_diffs, dtype=np.int64),
        )

    def _apply_data(self, data_d: Delta) -> None:
        cols = data_d.data
        filt = cols.get("__filter_data__")
        datas = cols["__data__"]
        # removals before insertions so an in-tick update (retract+insert
        # of the same key) lands in the index as the new value
        add_keys: list[int] = []
        add_datas: list[Any] = []
        add_filts: list[Any] = []
        order = np.argsort(data_d.diffs, kind="stable")
        for i in order:
            k = int(data_d.keys[i])
            if data_d.diffs[i] < 0:
                for _ in range(-int(data_d.diffs[i])):
                    self.engine.remove(k)
            else:
                for _ in range(int(data_d.diffs[i])):
                    add_keys.append(k)
                    add_datas.append(datas[i])
                    add_filts.append(filt[i] if filt is not None else None)
        if add_keys:
            add_batch = getattr(self.engine, "add_batch", None)
            if add_batch is not None:
                # one batched embed + insert per tick, not per document
                add_batch(add_keys, add_datas, add_filts)
            else:
                for k, d, f in zip(add_keys, add_datas, add_filts):
                    self.engine.add(k, d, f)
