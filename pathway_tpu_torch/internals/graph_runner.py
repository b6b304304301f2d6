"""GraphRunner — lowers the declarative parse graph to engine operators.

Re-design of ``python/pathway/internals/graph_runner/`` (GraphRunner
``__init__.py:36``, storage_graph, expression_evaluator — ~30 evaluators).
Here every Table kind lowers to a small engine-operator subgraph; columnar
layouts are simply the tables' column dicts (the reference's tuple-layout
planner ``path_evaluator.py`` is unnecessary with struct-of-arrays batches).
Tree-shaking (reference ``__init__.py:93,101``) falls out of memoized
recursion from the requested outputs.

Copy of ``pathway_tpu/internals/graph_runner.py``. ``GraphRunner(device=)``
(default ``"cuda"``) hands the device to every ``ColumnEnv`` it lowers
expressions in — the expression kernels launch there past their gate — and
to ``MeshComm(device=)`` under ``PATHWAY_MESH_EXCHANGE``. Its persistence
branch is the reference's: one ``PersistenceManager`` a worker in sharded
runs, ``Subscribe``'s ``skip_until`` at the persisted frontier, and the
delivery plane (``io/delivery.py``): one ``DeliverySink`` a sink behind a
``Subscribe``, transactional (ack cursor in the worker's namespace, release
at commit boundaries) on worker 0 when persistence is on, continuous
otherwise. The observability branch is the reference's: with
``with_http_server`` (or ``PATHWAY_MONITORING_HTTP_SERVER``) an
``ObservabilityHub`` over every worker's stats, its signals plane and
profiler, and the monitoring HTTP server (``engine/http_server.py``); the
periodic telemetry flusher (``PATHWAY_MONITORING_SERVER``, the trace file);
the dashboard at ``monitoring_level``; the tracer's ``graph.build`` span and
its flush and OTLP export at the run's end. The command line's replay mode
is the reference's: each worker's manager takes the record/replay
environment (``persistence.apply_replay_env``), and a plain ``Subscribe``
skips no persisted time while replaying. Left out: the multi-process
cluster and cross-host mesh branches, and ``Table.named`` pins (the port's
nodes carry no upgrade identity).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..engine import keys as K
from ..engine import operators as ops
from ..engine.executor import Executor, Node
from ..engine.reducers import make_reducer
from . import dtype as dt
from .expression import ColumnExpression, ColumnReference, HiddenRef, IdReference
from .expression_compiler import ColumnEnv, compile_expr
from .parse_graph import G
from .table import Table
from .thisclass import ThisPlaceholder


class GraphRunner:
    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self._cache: dict[int, Node] = {}
        self._nodes: list[Node] = []
        self.executor: Executor | None = None
        self.persistence: Any = None  # PersistenceManager when pw.run has one
        self.monitoring_level: int = 0
        self.with_http_server: bool = False
        #: request_stop() may fire while the graph is still building (before
        #: the executor exists); the flag is handed to the executor on
        #: creation so early stops aren't lost
        self.stop_requested: bool = False

    # ------------------------------------------------------------------

    def _env(self) -> ColumnEnv:
        return ColumnEnv(device=self.device)

    def _want_http_server(self) -> bool:
        if self.with_http_server:
            return True
        try:
            from .config import get_pathway_config

            return get_pathway_config().monitoring_http_server
        except RuntimeError:
            return False

    def _start_observability(self, workers, comm=None):
        """Hub + HTTP endpoints + periodic telemetry flusher for this
        process's workers. Returns (http_server, flusher, hub); each may
        be None. ``workers`` is [(worker_id, EngineStats), ...]."""
        from ..observability import ObservabilityHub
        from ..observability.exporter import start_periodic_flusher
        from .config import get_pathway_config

        http_server = None
        hub = None
        if self._want_http_server():
            from ..engine.http_server import start_http_server

            try:
                hub = ObservabilityHub.from_config(get_pathway_config())
            except RuntimeError:
                hub = ObservabilityHub()
            for w, stats in workers:
                hub.register_worker(w, stats)
                # /metrics serves per-operator latency histograms, which
                # need per-node timing on (the dashboard's ALL level)
                stats.detailed = True
            if comm is not None:
                hub.register_comm(comm)
            # signals plane: windowed time-series sampling of every
            # registered worker + comm backend, SLO rule evaluation, and
            # the /query‖/attribution‖/alerts surface (observability/
            # timeseries.py, slo.py) — lives and dies with the hub
            hub.start_signals()
            try:
                http_server, _ = start_http_server(hub)
            except OSError as e:
                # telemetry must not fail the run it observes: a taken
                # port (another pipeline on this host) degrades to
                # metrics-off, it does not abort the dataflow
                import warnings

                warnings.warn(
                    f"monitoring HTTP server failed to start: {e}; "
                    "continuing without /metrics",
                    RuntimeWarning,
                )
                http_server = None
        #: bound server exposed for tests/tools needing the ephemeral port
        self._http_server_for_tests = http_server
        flusher = start_periodic_flusher(hub)
        return http_server, flusher, hub

    @staticmethod
    def _stop_observability(http_server, flusher, hub=None) -> None:
        if flusher is not None:
            flusher.stop()
        if hub is not None:
            hub.close()  # signals sampler thread
        if http_server is not None:
            http_server.shutdown()
            http_server.server_close()

    def _execute(self) -> None:
        self.executor = Executor(self._nodes, persistence=self.persistence)
        if self.stop_requested:
            self.executor.request_stop()
        stop_dashboard = None
        http_server, flusher, _hub = self._start_observability(
            [(0, self.executor.stats)]
        )
        if self.monitoring_level:
            from .monitoring import start_dashboard

            stop_dashboard = start_dashboard(
                self.executor.stats, self.monitoring_level
            )
        try:
            self.executor.run()
        finally:
            if stop_dashboard is not None:
                stop_dashboard()
            self._stop_observability(http_server, flusher, _hub)
            from .telemetry import export_from_env
            from .tracing import get_tracer

            export_from_env(get_tracer())

    def run_tables(self, *tables: Table, include_sinks: bool = False):
        """Build + execute; return one Capture per requested table."""
        captures = [self.capture(t) for t in tables]
        if include_sinks:
            for sink in G.sinks:
                self.lower_sink(sink)
        self._execute()
        return captures

    def run(self) -> None:
        from .config import get_pathway_config
        from .tracing import get_tracer, span

        cfg = get_pathway_config()
        if cfg.processes > 1:
            raise NotImplementedError(
                "PATHWAY_PROCESSES > 1: the multi-process cluster "
                "(parallel/cluster.py) is not ported (ROADMAP.md Queue 1 "
                "item 9)"
            )
        if cfg.total_workers > 1:
            self._run_sharded(cfg)
            return
        try:
            with span("graph.build", n_sinks=len(G.sinks)):
                for sink in G.sinks:
                    self.lower_sink(sink)
            self._execute()
        finally:
            # a failed lowering still deserves its partial trace (executor
            # flushes are no-ops when nothing new happened since)
            tracer = get_tracer()
            if tracer is not None:
                tracer.flush()
                from .telemetry import export_from_env

                export_from_env(tracer)  # lowering-failure partial spans

    def _run_sharded(self, cfg) -> None:
        """Multi-worker execution (reference: timely workers over thread
        allocators). Every worker builds the same dataflow from the parse
        graph, owns the ``shard_of(key)`` slice of all stateful operator
        state, and exchanges records at stateful boundaries
        (engine/executor.shard_graph), on threads of this process."""
        import threading

        from ..parallel.comm import LocalComm, WorkerContext

        n_workers = cfg.total_workers
        comm = LocalComm(n_workers)
        if cfg.mesh_exchange:
            from ..parallel.meshcomm import MeshComm

            comm = MeshComm(comm, device=self.device)

        pcfg = getattr(self, "persistence_config", None)
        managers: list[Any] = []
        executors: list[Executor] = []
        from .tracing import span as _span

        errors: list[BaseException] = []

        def work(ex: Executor) -> None:
            try:
                ex.run()
            except BaseException as e:  # propagate cross-worker (panic model)
                errors.append(e)
                comm.abort()

        # comm exists from here on: a failed build must still close it (and
        # any managers), and still flush the partial trace
        try:
            with _span(
                "graph.build", n_sinks=len(G.sinks), n_workers=n_workers
            ):
                for w in range(n_workers):
                    worker_runner = GraphRunner(self.device)
                    if pcfg is not None:
                        from ..persistence import (
                            PersistenceManager,
                            apply_replay_env,
                        )

                        manager = PersistenceManager(
                            pcfg, worker_id=w, n_workers=n_workers
                        )
                        apply_replay_env(manager, cfg)
                        worker_runner.persistence = manager
                        managers.append(manager)
                    for sink in G.sinks:
                        worker_runner.lower_sink(sink)
                    executors.append(
                        Executor(
                            worker_runner._nodes,
                            ctx=WorkerContext(w, n_workers, comm),
                            persistence=worker_runner.persistence,
                        )
                    )
            self.executor = executors[0]
            self._peer_executors = executors
            if self.stop_requested:
                for ex in executors:
                    ex.request_stop()

            # this process serves its workers' stats (one process: the
            # port's runner refuses PATHWAY_PROCESSES > 1)
            http_server, flusher, _hub = self._start_observability(
                list(enumerate(ex.stats for ex in executors)), comm=comm
            )
            try:
                threads = [
                    threading.Thread(target=work, args=(ex,), daemon=True)
                    for ex in executors
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            finally:
                self._stop_observability(http_server, flusher, _hub)
        finally:
            comm.close()
            for manager in managers:
                manager.close()
            from .telemetry import export_from_env
            from .tracing import get_tracer

            tracer = get_tracer()
            if tracer is not None:
                tracer.flush()
                export_from_env(tracer)
        if errors:
            primary = [
                e for e in errors
                if "peer worker failed" not in str(e)
            ]
            raise (primary or errors)[0]

    def capture(self, table: Table) -> ops.Capture:
        node = self.lower(table)
        cap = ops.Capture(node)
        self._nodes.append(cap)
        return cap

    def _build_delivery_sink(self, spec: dict) -> Any:
        """Instantiate one delivery-managed sink (io/delivery.py) for this
        worker's runner. The DeliveryManager attaches to the persistence
        manager on EVERY worker (so all workers agree on the finish-path
        commit ordering), but only worker 0's sinks are transactional —
        sink callbacks gather there, and a peer's idle cursor must never
        drag the cluster's recovery floor down."""
        from ..io import delivery as _dlv

        mgr = getattr(self, "_delivery_mgr", None)
        worker_id = (
            self.persistence.worker_id if self.persistence is not None else 0
        )
        if mgr is None:
            mgr = self._delivery_mgr = _dlv.DeliveryManager(worker_id)
            if self.persistence is not None:
                self.persistence.delivery = mgr
        active = worker_id == 0
        transactional = self.persistence is not None and active
        dsink = _dlv.DeliverySink(
            spec["adapter_factory"](),
            spec["name"],
            policy=spec.get("retry_policy"),
            worker_id=worker_id,
            backend=self.persistence.backend if transactional else None,
            transactional=transactional,
            dlq=mgr.dlq,
        )
        mgr.add(dsink)
        return dsink

    def lower_sink(self, sink: Any) -> None:
        kind = sink["kind"]
        if kind == "subscribe":
            node = self.lower(sink["table"])
            dspec = sink.get("delivery")
            if dspec is not None:
                # delivery-managed sink: retries/acks/DLQ live in the
                # delivery layer; recovery dedup is the durable ack
                # cursor, NOT skip_until — replayed output above the
                # restore point must REACH the sink for re-delivery
                dsink = self._build_delivery_sink(dspec)
                self._nodes.append(ops.Subscribe(
                    node,
                    on_batch=dsink.on_batch,
                    on_end=dsink.on_end,
                    skip_until=-1,
                ))
                return
            skip_until = -1
            if (
                self.persistence is not None
                and sink.get("skip_persisted_batch", True)
                # CLI replay re-emits the recorded history — that is the
                # point; skip-persisted is a RECOVERY dedup mechanism
                and getattr(self.persistence, "replay_mode", None) is None
            ):
                skip_until = self.persistence.last_time
            self._nodes.append(ops.Subscribe(
                node,
                on_change=sink.get("on_change"),
                on_time_end=sink.get("on_time_end"),
                on_end=sink.get("on_end"),
                on_batch=sink.get("on_batch"),
                skip_until=skip_until,
            ))
        elif kind == "callable":
            sink["build"](self)
        else:
            raise NotImplementedError(f"sink kind {kind}")

    # ------------------------------------------------------------------

    def _add(self, node: Node) -> Node:
        self._nodes.append(node)
        return node

    def lower(self, table: Table) -> Node:
        key = id(table)
        if key in self._cache:
            return self._cache[key]
        node = self._lower(table)
        scope = getattr(table, "_error_scope", None)
        if scope is not None and getattr(node, "error_scope", None) is None:
            # pw.local_error_log() attribution: errors raised while this
            # node processes carry the scope its table was built under
            node.error_scope = scope
        self._cache[key] = node
        return node

    def _lower(self, table: Table) -> Node:
        kind = table._kind
        p = table._params
        if kind == "static":
            return self._add(ops.StaticSource(p["keys"], p["data"]))
        if kind == "scheduled":
            from ..engine.delta import Delta

            batches = [
                (t, Delta(keys=k, data=data, diffs=diffs))
                for (t, k, data, diffs) in p["batches"]
            ]
            return self._add(ops.ScheduledSource(p["columns"], batches))
        if kind == "source":
            return self._add(p["build"]())
        if kind == "rowwise":
            return self._lower_rowwise(table)
        if kind == "filter":
            return self._lower_filter(table)
        if kind == "remove_errors":
            return self._add(ops.RemoveErrors(self.lower(table._inputs[0])))
        if kind == "reindex":
            return self._lower_reindex(table)
        if kind == "groupby_reduce":
            return self._lower_groupby(table)
        if kind == "join_select":
            return self._lower_join(table)
        if kind == "concat":
            inputs = [self.lower(t) for t in table._inputs]
            aligned = [
                self._project(n, t, table.column_names())
                for n, t in zip(inputs, table._inputs)
            ]
            # structurally proven disjointness (difference/intersection
            # shapes) needs no runtime liveness state; promised-only
            # disjointness is verified by the engine
            proven = G.solver.query_are_disjoint(
                *[t._universe for t in table._inputs], structural_only=True
            )
            return self._add(ops.Concat(aligned, verify=not proven))
        if kind == "concat_reindex":
            parts = []
            for i, t in enumerate(table._inputs):
                n = self.lower(t)
                salt = 0xC0 + i
                rw = self._add(ops.Rowwise(n, {
                    **{c: _colref(c) for c in t.column_names()},
                    "__newkey__": (lambda cols, keys, s=salt: K.derive(keys, s)),
                }))
                parts.append(self._add(ops.Reindex(rw, "__newkey__",
                                                   keep=table.column_names())))
            return self._add(ops.Concat(parts))
        if kind == "update_rows":
            l = self._project(self.lower(table._inputs[0]), table._inputs[0], table.column_names())
            r = self._project(self.lower(table._inputs[1]), table._inputs[1], table.column_names())
            return self._add(ops.UpdateRows(l, r))
        if kind == "update_cells":
            l = self.lower(table._inputs[0])
            r = self.lower(table._inputs[1])
            return self._add(ops.UpdateCells(l, r, p["override"]))
        if kind in ("restrict", "intersect", "with_universe_of"):
            if kind == "with_universe_of":
                return self.lower(table._inputs[0])
            self_node = self.lower(table._inputs[0])
            other_node = self.lower(table._inputs[1])
            cols = table.column_names()
            return self._add(ops.Join(
                self_node, other_node, None, None,
                left_cols=cols, right_cols=[], out_names=cols,
                mode="inner", key_mode="left",
            ))
        if kind == "difference":
            self_node = self.lower(table._inputs[0])
            other_node = self.lower(table._inputs[1])
            cols = table.column_names()
            return self._add(ops.Join(
                self_node, other_node, None, None,
                left_cols=cols, right_cols=[], out_names=cols,
                mode="left", key_mode="left", emit_matched=False,
            ))
        if kind == "having":
            # result = rows of the indexer's table whose pointer is a key
            # of base, keyed by the indexer table's ids and carrying base's
            # columns (reference HavingContext: universe ⊆ indexer's)
            base_t, other_t = table._inputs
            other_node, env = self._zip_env(other_t, {"__k": p["key_expr"]})
            kc = compile_expr(p["key_expr"], env)
            rw = self._add(ops.Rowwise(other_node, {"__ptr__": kc.fn}))
            base_node = self.lower(base_t)
            cols = table.column_names()
            return self._add(ops.Join(
                rw, base_node, "__ptr__", None,
                left_cols=[], right_cols=cols, out_names=cols,
                mode="inner", key_mode="left",
            ))
        if kind == "ix":
            return self._lower_ix(table)
        if kind == "flatten":
            inp = self.lower(table._inputs[0])
            node = ops.Flatten(inp, p["column"])
            if "origin_id" in p:
                src = self._add(ops.Rowwise(inp, {
                    **{c: _colref(c) for c in table._inputs[0].column_names()},
                    p["origin_id"]: (lambda cols, keys: keys),
                }))
                node = ops.Flatten(src, p["column"])
            return self._add(node)
        if kind == "deduplicate":
            base_t = table._inputs[0]
            exprs: dict[str, ColumnExpression] = {"__val__": p["value"]}
            if p["instance"] is not None:
                exprs["__inst__"] = p["instance"]
            node, env = self._zip_env(base_t, exprs)
            rw_cols = {c: _colref(c) for c in base_t.column_names()}
            rw_cols["__val__"] = compile_expr(p["value"], env).fn
            if p["instance"] is not None:
                rw_cols["__inst__"] = compile_expr(p["instance"], env).fn
            rw = self._add(ops.Rowwise(node, rw_cols))
            dd = self._add(ops.Deduplicate(
                rw, "__val__",
                "__inst__" if p["instance"] is not None else None,
                p["acceptor"],
            ))
            return self._add(ops.Rowwise(dd, {
                c: _colref(c) for c in table.column_names()
            }))
        if kind == "gradual_broadcast":
            main_t, thr_t = table._inputs
            main = self.lower(main_t)
            lower_e, value_e, upper_e = p["cols"]
            thr_node, env = self._zip_env(thr_t, {
                "__l": lower_e, "__v": value_e, "__u": upper_e,
            })
            thr_rw = self._add(ops.Rowwise(thr_node, {
                "__l": compile_expr(lower_e, env).fn,
                "__v": compile_expr(value_e, env).fn,
                "__u": compile_expr(upper_e, env).fn,
            }))
            return self._add(ops.GradualBroadcast(
                main, thr_rw, ("__l", "__v", "__u")
            ))
        if kind == "custom":
            # stdlib escape hatch: the table carries its own lowering function
            return p["lower"](self, table)
        if kind == "iter_pin":
            raise RuntimeError(
                "pw.iterate placeholder table used outside its iterate body "
                f"(input {p.get('name')!r}) — tables created inside the "
                "iterated function must not escape it"
            )
        raise NotImplementedError(f"lowering for kind {kind!r}")

    # ------------------------------------------------------------------

    def _project(self, node: Node, t: Table, names: list[str]) -> Node:
        if node.column_names == names:
            return node
        return self._add(ops.Rowwise(node, {c: _colref(c) for c in names}))

    def _zip_env(
        self, primary: Table, exprs: dict[str, ColumnExpression]
    ) -> tuple[Node, ColumnEnv]:
        """Engine node + env for expressions over `primary` that may also
        reference other (same/super-universe) tables — foreign columns are
        zipped in by key (engine Join on row keys, key_mode='left')."""
        foreign: list[Table] = []
        need_foreign_id: set[int] = set()
        seen = {id(primary)}

        def walk(e: ColumnExpression) -> None:
            if isinstance(e, ColumnReference) and not isinstance(e.table, ThisPlaceholder):
                t = e.table
                if isinstance(t, Table) and id(t) not in seen:
                    seen.add(id(t))
                    foreign.append(t)
                if isinstance(e, IdReference) and t is not primary and isinstance(t, Table):
                    need_foreign_id.add(id(t))
            for d in getattr(e, "_deps", ()):
                walk(d)

        for e in exprs.values():
            walk(e)

        env = self._env()
        env.add_table(primary)
        node = self.lower(primary)
        cur_cols = list(node.column_names)
        for i, ft in enumerate(foreign):
            # foreign table must cover every primary row: primary ⊆ foreign
            if not (
                primary._universe.is_subset_of(ft._universe)
                or primary._universe.is_equal(ft._universe)
            ):
                raise ValueError(
                    f"column of table {ft!r} used in a context with a different "
                    "universe; consider promise_universes_are_equal"
                )
            fnode = self.lower(ft)
            prefix = f"__f{i}."
            fexprs = {prefix + c: _colref(c) for c in ft.column_names()}
            fexprs[prefix + "id"] = lambda cols, keys: keys
            frw = self._add(ops.Rowwise(fnode, fexprs))
            out_names = cur_cols + list(fexprs.keys())
            node = self._add(ops.Join(
                node, frw, None, None,
                left_cols=cur_cols, right_cols=list(fexprs.keys()),
                out_names=out_names, mode="inner", key_mode="left",
            ))
            cur_cols = out_names
            for c, cs in ft.schema.columns().items():
                env.add(ft, c, prefix + c, cs.dtype)
            env.add(ft, "id", prefix + "id", dt.POINTER)
        return node, env

    def _lower_rowwise(self, table: Table) -> Node:
        primary = table._inputs[0]
        node, env = self._zip_env(primary, table._params["exprs"])
        compiled = {
            name: compile_expr(e, env).fn
            for name, e in table._params["exprs"].items()
        }
        return self._add(ops.Rowwise(node, compiled))

    def _lower_filter(self, table: Table) -> Node:
        primary = table._inputs[0]
        pred = table._params["predicate"]
        node, env = self._zip_env(primary, {"__pred__": pred})
        pc = compile_expr(pred, env)
        filtered = self._add(ops.Filter(node, pc.fn))
        return self._project(filtered, primary, table.column_names())

    def _lower_reindex(self, table: Table) -> Node:
        primary = table._inputs[0]
        key_expr = table._params["key_expr"]
        node, env = self._zip_env(primary, {"__k": key_expr})
        kc = compile_expr(key_expr, env)
        rw = self._add(ops.Rowwise(node, {
            **{c: _colref(c) for c in table.column_names()},
            "__newkey__": kc.fn,
        }))
        return self._add(ops.Reindex(rw, "__newkey__", keep=table.column_names()))

    def _lower_groupby(self, table: Table) -> Node:
        primary = table._inputs[0]
        p = table._params
        grouping: list[ColumnExpression] = p["grouping"]
        reducers = p["reducers"]
        all_exprs: dict[str, ColumnExpression] = {}
        for i, g in enumerate(grouping):
            all_exprs[f"gk{i}"] = g
        for out_name, rname, rargs, rkw in reducers:
            for j, a in enumerate(rargs):
                all_exprs[f"__a_{out_name}_{j}"] = a
        node, env = self._zip_env(primary, all_exprs)
        pre = {name: compile_expr(e, env).fn for name, e in all_exprs.items()}
        pre_node = self._add(ops.Rowwise(node, pre))

        engine_reducers = []
        for out_name, rname, rargs, rkw in reducers:
            if rname in ("sorted_tuple", "tuple", "ndarray"):
                impl = make_reducer(rname, skip_nones=rkw.get("skip_nones", False))
            elif rname == "stateful":
                from ..engine.reducers import StatefulReducer

                impl = StatefulReducer(rkw["combine_fn"])
            elif rname == "custom_accumulator":
                from ..engine.reducers import CustomAccumulatorReducer

                impl = CustomAccumulatorReducer(rkw["accumulator"])
            else:
                impl = make_reducer(rname)
            engine_reducers.append(
                (out_name, impl, [f"__a_{out_name}_{j}" for j in range(len(rargs))])
            )
        group_cols = [f"gk{i}" for i in range(len(grouping))]
        by_id = p["by_id"] and len(grouping) == 1
        gb = self._add(ops.GroupByReduce(
            pre_node, group_cols, engine_reducers,
            key_from_column="gk0" if by_id else None,
            skip_errors=p.get("skip_errors", True),
        ))
        # post projection: grouping refs -> gk{i}, hidden refs resolve directly
        post_env = self._env()
        for name, i in p["group_names"].items():
            g = grouping[i]
            src = g.table if isinstance(g, ColumnReference) and isinstance(g.table, Table) else primary
            cs = src.schema.columns().get(name) if hasattr(src, "schema") else None
            post_env.add(src, name, f"gk{i}", cs.dtype if cs is not None else dt.ANY)
            if src is not primary:
                post_env.add(primary, name, f"gk{i}", cs.dtype if cs is not None else dt.ANY)
        post = {}
        for name, e in p["outputs"].items():
            post[name] = compile_expr(e, post_env).fn
        return self._add(ops.Rowwise(gb, post))

    def _lower_join(self, table: Table) -> Node:
        lt, rt = table._inputs
        p = table._params
        lnode, lenv = self._zip_env(lt, {f"__c{i}": e for i, e in enumerate(p["left_on"])})
        rnode, renv = self._zip_env(rt, {f"__c{i}": e for i, e in enumerate(p["right_on"])})
        l_on = [compile_expr(e, lenv).fn for e in p["left_on"]]
        r_on = [compile_expr(e, renv).fn for e in p["right_on"]]

        def jk_fn(fns):
            def fn(cols, keys):
                n = len(keys)
                vals = [np.asarray(_mat(f(cols, keys), n)) for f in fns]
                jks = K.mix_columns(vals, n)
                from ..engine.error import Error as _Err, errors_seen

                if errors_seen():
                    # Error join keys hash by repr and would spuriously
                    # match each other — mark them with the reserved
                    # sentinel; the Join node drops sentinel rows + logs
                    for v in vals:
                        if v.dtype == object:
                            m = np.fromiter(
                                (type(x) is _Err for x in v), bool, n
                            )
                            if m.any():
                                jks[m] = K.ERROR_KEY
                return jks
            # static analysis (shard-skew pass): the per-key compiled
            # kernels carry _pw_dtype/_pw_expr breadcrumbs; expose them
            # through the mixing closure the Rowwise node actually holds
            fn._pw_key_fns = fns
            return fn

        lrw = self._add(ops.Rowwise(lnode, {
            **{f"l.{c}": _colref(c) for c in lt.column_names()},
            "l.__id__": lambda cols, keys: keys,
            "__jk__": jk_fn(l_on),
        }))
        rrw = self._add(ops.Rowwise(rnode, {
            **{f"r.{c}": _colref(c) for c in rt.column_names()},
            "r.__id__": lambda cols, keys: keys,
            "__jk__": jk_fn(r_on),
        }))
        lcols = [f"l.{c}" for c in lt.column_names()] + ["l.__id__"]
        rcols = [f"r.{c}" for c in rt.column_names()] + ["r.__id__"]
        key_mode = {"left": "left", "right": "right", None: "pair"}[p["id_side"]]
        join_node = self._add(ops.Join(
            lrw, rrw, "__jk__", "__jk__",
            left_cols=lcols, right_cols=rcols, out_names=lcols + rcols,
            mode=p["mode"], key_mode=key_mode,
            react_to_right=not p.get("asof_now", False),
        ))
        env = self._env()
        l_opt = p["mode"] in ("right", "outer")
        r_opt = p["mode"] in ("left", "outer")
        for c, cs in lt.schema.columns().items():
            env.add(lt, c, f"l.{c}", dt.Optional(cs.dtype) if l_opt else cs.dtype)
        env.add(lt, "id", "l.__id__", dt.Optional(dt.POINTER) if l_opt else dt.POINTER)
        for c, cs in rt.schema.columns().items():
            env.add(rt, c, f"r.{c}", dt.Optional(cs.dtype) if r_opt else cs.dtype)
        env.add(rt, "id", "r.__id__", dt.Optional(dt.POINTER) if r_opt else dt.POINTER)
        post = {name: compile_expr(e, env).fn for name, e in p["exprs"].items()}
        return self._add(ops.Rowwise(join_node, post))

    def _lower_ix(self, table: Table) -> Node:
        context_t, src_t = table._inputs
        p = table._params
        node, env = self._zip_env(context_t, {"__k": p["key_expr"]})
        kc = compile_expr(p["key_expr"], env)
        rw = self._add(ops.Rowwise(node, {"__ptr__": kc.fn}))
        src_node = self.lower(src_t)
        cols = table.column_names()
        src_proj = self._project(src_node, src_t, src_t.column_names())
        if p["optional"]:
            return self._add(ops.Join(
                rw, src_proj, "__ptr__", None,
                left_cols=[], right_cols=src_t.column_names(), out_names=cols,
                mode="left",
                key_mode="left",
            ))
        # strict ix: a PERMANENTLY missing key is a runtime KeyError
        # (reference test_common.py:2480 test_ix_missing_key). The check
        # fires at end-of-stream, not per tick — a probe may legitimately
        # arrive a commit before its indexed row does (incremental join
        # semantics); only a probe still unmatched when the frontier
        # closes is an error. Infinite streams never raise, they just
        # withhold the unmatched probe rows, exactly as the inner join.
        joined = self._add(ops.Join(
            rw, src_proj, "__ptr__", None,
            left_cols=[], right_cols=src_t.column_names(), out_names=cols,
            mode="inner",
            key_mode="left",
        ))
        self._add(ops.IxStrictCheck(rw, joined))
        return joined


def _colref(name: str):
    return lambda cols, keys, n=name: cols[n]


def _mat(v, n):
    from .expression_compiler import _materialize

    return _materialize(v, n)
