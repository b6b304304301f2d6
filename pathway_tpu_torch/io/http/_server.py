"""``pw.io.http.rest_connector`` — HTTP requests as a streaming table.

Copy of ``pathway_tpu/io/http/_server.py`` over the port's engine: each HTTP request becomes a
row of a query table keyed by a unique request key (``engine/keys.py::ref_scalar``); the user
pipeline computes a result row under the same key; the response writer sink completes the
pending HTTP response at the tick's end, once the frontier has passed every operator on the path
(the reference's legacy first-emission writer, ``PATHWAY_SERVE_QUIESCENT=0``, is not ported).
``PathwayWebserver`` is the reference's ``aiohttp`` server, with its routes, JSON bodies, status
codes (400, 429 with ``Retry-After``, 500, 504) and the ``X-Pathway-Deadline-Ms`` request header;
the ``X-Pathway-Degraded`` answer of sharded serving comes with that branch.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import threading
from typing import Any, Callable, Sequence

from ...engine import keys as K
from ...internals.json import Json
from ...internals.schema import SchemaMetaclass, schema_from_types
from ...internals.table import Table
from ..python import ConnectorSubject, read as python_read

__all__ = ["PathwayWebserver", "rest_connector", "terminate_all"]

_live_webservers: list["PathwayWebserver"] = []


def terminate_all() -> None:
    """Stop every live webserver (test teardown helper; the reference tests
    kill the whole process instead)."""
    for ws in list(_live_webservers):
        ws.terminate()
    _live_webservers.clear()

_request_counter = itertools.count(1)


def _json_default(v: Any):
    import numpy as np

    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, Json):
        return v.value
    if isinstance(v, (set, tuple)):
        return list(v)
    return str(v)


def _dumps(v: Any) -> str:
    return json.dumps(v, default=_json_default)


class PathwayWebserver:
    """One aiohttp server shared by any number of rest_connector routes
    (reference _server.py:329)."""

    def __init__(self, host: str, port: int, with_cors: bool = False):
        import aiohttp.web as web

        self.host = host
        self.port = port
        self._web = web
        self._app = web.Application()
        self._routes: dict[tuple[str, str], Any] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._runner = None
        self._started = threading.Event()
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None

    def _add_route(self, route: str, methods: Sequence[str], handler) -> None:
        for m in methods:
            self._app.router.add_route(m, route, handler)

    #: dtype -> OpenAPI type (reference _ENGINE_TO_OPENAPI_TYPE)
    _OPENAPI_TYPES = {
        "INT": "integer", "FLOAT": "number", "STR": "string",
        "BOOL": "boolean", "BYTES": "string",
        "DATE_TIME_NAIVE": "string", "DATE_TIME_UTC": "string",
        "DURATION": "string",
    }

    def openapi_description_json(self, host: str) -> dict:
        """OpenAPI v3 document for every registered rest_connector route
        (reference _server.py openapi_description_json): per-route JSON
        request-body schemas built from the pw.Schema — columns without
        defaults are required, un-typeable columns (Json/Any) turn on
        additionalProperties."""
        from ...internals import dtype as dt

        paths: dict[str, dict] = {}
        for route, (schema, methods) in sorted(self._routes.items()):
            properties: dict[str, dict] = {}
            required: list[str] = []
            additional = False
            for name, col in schema.columns().items():
                base = dt.unoptionalize(col.dtype)
                typ = self._OPENAPI_TYPES.get(repr(base))
                if typ is None:
                    additional = True
                    continue
                field: dict = {"type": typ}
                if col.has_default:
                    field["default"] = col.default_value
                else:
                    required.append(name)
                properties[name] = field
            body_schema: dict = {
                "type": "object",
                "properties": properties,
                "additionalProperties": additional,
            }
            if required:
                body_schema["required"] = required
            responses = {
                "200": {"description": "OK"},
                "400": {
                    "description": "The request is incorrect. Please check "
                    "if it complies with the auto-generated and input "
                    "table schemas"
                },
            }
            ops: dict[str, dict] = {}
            for m in methods:
                if m == "GET":
                    ops["get"] = {
                        "parameters": [
                            {
                                "name": n,
                                "in": "query",
                                "required": n in required,
                                "schema": {"type": p["type"]},
                            }
                            for n, p in properties.items()
                        ],
                        "responses": dict(responses),
                    }
                else:
                    ops[m.lower()] = {
                        "requestBody": {
                            "content": {
                                "application/json": {"schema": body_schema}
                            },
                        },
                        "responses": dict(responses),
                    }
            paths[route] = ops
        return {
            "openapi": "3.0.3",
            "info": {"title": "Pathway API", "version": "1.0.0"},
            "servers": [{"url": f"http://{host}"}],
            "paths": paths,
        }

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)

    def _serve(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def main():
            self._runner = self._web.AppRunner(self._app)
            await self._runner.setup()
            site = self._web.TCPSite(self._runner, self.host, self.port)
            await site.start()
            self._started.set()
            while not self._stopped.is_set():
                await asyncio.sleep(0.05)
            await self._runner.cleanup()

        try:
            self._loop.run_until_complete(main())
        finally:
            self._started.set()
            self._loop.close()

    def terminate(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class _RestSubject(ConnectorSubject):
    """Bridges HTTP handlers to the engine queue; keeps pending futures by
    request key."""

    def __init__(
        self,
        webserver: PathwayWebserver,
        route: str,
        methods: Sequence[str],
        schema: SchemaMetaclass,
        delete_completed_queries: bool,
        request_validator: Callable | None,
    ):
        super().__init__(datasource_name="rest")
        self.webserver = webserver
        self.schema = schema
        self.delete_completed_queries = delete_completed_queries
        self.request_validator = request_validator
        self._futures: dict[int, asyncio.Future] = {}
        self._rows: dict[int, dict[str, Any]] = {}
        self._names = schema.column_names()
        webserver._add_route(route, methods, self._handle)

    #: cap on how long one admission wait may hold an executor thread;
    #: past it the client gets 429 + Retry-After instead of a slot
    _ADMIT_WAIT_S = 2.0

    async def _handle(self, request):
        web = self.webserver._web
        try:
            return await self._handle_inner(request, web)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # a handler bug answers as structured JSON, never a bare 500
            # page (and never a silently dropped connection)
            return web.json_response(
                {"error": str(e), "kind": type(e).__name__}, status=500
            )

    async def _handle_inner(self, request, web):
        from ...serve.admission import shared_controller
        from ...serve.merge import default_deadline_ms
        from ...serve.stats import bump as serve_bump

        if request.method in ("POST", "PUT", "PATCH"):
            try:
                payload = await request.json()
            except Exception:
                payload = {}
        else:
            payload = dict(request.query)
        if self.request_validator is not None:
            try:
                issue = self.request_validator(payload)
                if issue is not None:
                    raise ValueError(str(issue))
            except Exception as e:
                return web.json_response({"error": str(e)}, status=400)
        row = {}
        for n, cs in self.schema.columns().items():
            if n in payload:
                v = payload[n]
                if isinstance(v, (dict, list)):
                    v = Json(v)
                row[n] = v
            elif cs.has_default:
                row[n] = cs.default_value
            else:
                return web.json_response(
                    {"error": f"missing field {n!r}"}, status=400
                )

        # per-query deadline: client header beats the knob default
        deadline_ms = default_deadline_ms()
        hdr = request.headers.get("X-Pathway-Deadline-Ms")
        if hdr:
            try:
                deadline_ms = max(1.0, float(hdr))
            except ValueError:
                return web.json_response(
                    {"error": "bad X-Pathway-Deadline-Ms"}, status=400
                )

        ctrl = shared_controller()
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        admit = loop.run_in_executor(
            None,
            ctrl.try_admit,
            min(self._ADMIT_WAIT_S, deadline_ms / 1e3),
        )
        try:
            slot = await admit
        except asyncio.CancelledError:
            # client gone while waiting at the door: a slot granted after
            # this point must go straight back
            admit.add_done_callback(
                lambda f: (
                    ctrl.cancel(f.result())
                    if not f.cancelled()
                    and f.exception() is None
                    and f.result() is not None
                    else None
                )
            )
            raise
        if slot is None:
            # saturated: shed at the door with back-off advice so the
            # accepted-query tail stays bounded
            retry_s = ctrl.retry_after_s()
            return web.json_response(
                {"error": "saturated", "retry_after_s": round(retry_s, 3)},
                status=429,
                headers={"Retry-After": str(max(1, int(retry_s + 0.999)))},
            )

        key = int(K.ref_scalar(next(_request_counter), salt=0x9E57))
        fut = asyncio.get_event_loop().create_future()
        self._futures[key] = fut
        if self.delete_completed_queries:
            self._rows[key] = row  # kept only for the later retraction
        try:
            self._next_with_key(key, **row)
            self.commit()
            remaining_s = max(0.001, deadline_ms / 1e3 - (loop.time() - t0))
            try:
                result = await asyncio.wait_for(fut, timeout=remaining_s)
            except asyncio.TimeoutError:
                self._futures.pop(key, None)
                serve_bump("deadline_dropped_total")
                return web.json_response({"error": "timeout"}, status=504)
            if isinstance(result, Json):
                result = result.value
            return web.json_response(result, dumps=_dumps)
        except asyncio.CancelledError:
            # client disconnected mid-flight: free the slot now, drop the
            # pending future (the engine's late answer finds nobody)
            self._futures.pop(key, None)
            ctrl.cancel(slot)
            slot = None
            raise
        finally:
            if slot is not None:
                ctrl.release(slot, service_s=loop.time() - t0)

    def _complete(self, key: int, value: Any) -> None:
        """Called from the engine thread by the response writer sink."""
        fut = self._futures.pop(key, None)
        if fut is not None and not fut.done():
            loop = self.webserver._loop
            if loop is not None and loop.is_running():
                loop.call_soon_threadsafe(
                    lambda: None if fut.done() else fut.set_result(value)
                )
        # retract the query even when the HTTP side already timed out —
        # otherwise timed-out queries pile up in the live table forever
        if self.delete_completed_queries:
            row = self._rows.pop(key, None)
            if row is not None:
                self._next_with_key(key, diff=-1, **row)
                self.commit()

    def run(self) -> None:
        self.webserver.start()
        # the reader thread just waits for server shutdown
        self.webserver._stopped.wait()
        self.close()


def rest_connector(
    host: str | None = None,
    port: int | None = None,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    schema: SchemaMetaclass | None = None,
    methods: Sequence[str] = ("POST",),
    autocommit_duration_ms: int | None = 50,
    keep_queries: bool | None = None,
    delete_completed_queries: bool = False,
    request_validator: Callable | None = None,
) -> tuple[Table, Callable[[Table], None]]:
    """HTTP endpoint as a (query_table, response_writer) pair
    (reference io/http/_server.py:624)."""
    if webserver is None:
        if host is None or port is None:
            raise ValueError("pass host+port or a PathwayWebserver")
        webserver = PathwayWebserver(host, port)
    if webserver not in _live_webservers:
        _live_webservers.append(webserver)
    if schema is None:
        schema = schema_from_types(query=str, user=str)
    if keep_queries is not None:
        delete_completed_queries = not keep_queries

    webserver._routes[route] = (schema, tuple(m.upper() for m in methods))
    subject = _RestSubject(
        webserver, route, methods, schema, delete_completed_queries,
        request_validator,
    )
    table = python_read(
        subject, schema=schema, autocommit_duration_ms=autocommit_duration_ms
    )

    def response_writer(result_table: Table) -> None:
        from .. import subscribe

        cols = result_table.column_names()

        def _value_of(row):
            return row.get("result") if "result" in cols else row

        # frontier-quiescent respond(): buffer the latest addition per key
        # and resolve only at on_time_end, i.e. after the commit wave's
        # frontier has passed every operator on the query→response path.
        # Intra-tick retract+replace cascades (e.g. DataIndex collapsed
        # repack) therefore answer with the settled row, never an interim
        # one. Single-wave queries see no added latency: on_time_end fires
        # in the same topological sweep that produced the emission.
        pending: dict[int, Any] = {}
        lock = threading.Lock()

        def on_change(key, row, time, is_addition):
            k = int(key)
            value = _value_of(row)
            with lock:
                if is_addition:
                    pending[k] = value
                elif k in pending and pending[k] == value:
                    # a retraction of the exact buffered value cancels it
                    # (ordering of retract/add within a wave is free)
                    del pending[k]

        def on_time_end(time):
            with lock:
                ready = list(pending.items())
                pending.clear()
            for k, value in ready:
                subject._complete(k, value)

        subscribe(result_table, on_change=on_change, on_time_end=on_time_end)

    return table, response_writer
