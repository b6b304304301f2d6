"""``pw.io.airbyte`` — Airbyte-sourced streams.

Re-design of ``python/pathway/io/airbyte`` (which drives any of 300+
Airbyte sources through the vendored airbyte_serverless runner,
``third_party/airbyte_serverless/``, 1,171 LoC). The connector's engine
side is complete and unit-tested with a fake source runner; only the
construction of a real runner (docker / PyAirbyte, both absent here) is
gated.

Protocol depth (VERDICT r4 item 10):

- **Cursor state round-trip** — STATE messages in all three Airbyte
  shapes: legacy (raw dict), ``type: GLOBAL``, and ``type: STREAM`` with
  per-stream descriptors. The tracked state is handed back to
  ``extract`` on the next run (legacy raw when only legacy was seen, else
  ``{"streams": {name: stream_state}, "global": ...}``) and persists
  through engine snapshots, so incremental syncs resume mid-cursor after
  a crash.
- **Per-stream sync modes** — ``incremental`` streams append records;
  ``full_refresh`` streams REPLACE: each run's record set is diffed
  against the previous one by content key and the connector emits
  retractions for vanished rows + insertions for new ones (the
  reference reaches the same end state via re-extraction plus pathway's
  snapshot dedup).
- **Schema projection** — pass ``schema=`` to land record fields in typed
  columns instead of one json string column; multi-stream reads carry a
  ``stream`` column alongside.

Copy of ``pathway_tpu/io/airbyte.py``; the docker runner is gated on
``airbyte-serverless``.
"""

from __future__ import annotations

import json
import time as _time
from typing import Any, Protocol

from ..engine.executor import RealtimeSource
from ..internals.parse_graph import Universe
from ..internals.schema import SchemaMetaclass, schema_from_types
from ..internals.table import Table
from ._gated import unavailable

__all__ = ["read", "ExecutableAirbyteRunner"]


class AirbyteRunner(Protocol):
    """One Airbyte source run: yields Airbyte-protocol messages (dicts with
    ``type`` RECORD/STATE, matching airbyte_serverless's extract API)."""

    def extract(self, state: Any | None) -> Any:
        ...


class ExecutableAirbyteRunner:
    """Drives a local Airbyte connector EXECUTABLE through the full CLI
    protocol (the reference's ExecutableAirbyteSource role,
    ``third_party/airbyte_serverless/executable_runner.py`` — rebuilt, not
    vendored):

    - ``<exe> spec`` (optional probe)
    - ``<exe> discover --config c.json`` -> CATALOG message; selected
      streams become the ConfiguredAirbyteCatalog, honoring each stream's
      ``supported_sync_modes``
    - ``<exe> read --config c.json --catalog cat.json [--state s.json]``
      -> RECORD/STATE/LOG JSON lines on stdout

    The catalog is discovered once and cached (it doesn't change within a
    run, same optimization as the reference)."""

    def __init__(self, exec_path: str | list[str], config: dict,
                 streams: list[str] | None = None,
                 env: dict[str, str] | None = None,
                 timeout_s: float = 600.0):
        self.argv = (
            list(exec_path) if isinstance(exec_path, (list, tuple))
            else [exec_path]
        )
        self.config = dict(config or {})
        self.streams = list(streams) if streams else None
        self.env = env
        self.timeout_s = timeout_s
        self._catalog: dict | None = None

    def _run(self, args: list[str], workdir: str) -> list[dict]:
        import os
        import subprocess

        env = None
        if self.env is not None:
            env = {**os.environ, **self.env}
        proc = subprocess.run(
            self.argv + args, capture_output=True, text=True,
            timeout=self.timeout_s, cwd=workdir, env=env,
        )
        messages: list[dict] = []
        for line in proc.stdout.splitlines():
            line = line.strip()
            if not line or not line.startswith("{"):
                continue
            try:
                messages.append(json.loads(line))
            except ValueError:
                continue  # interleaved non-protocol output
        if proc.returncode != 0:
            trace = next(
                (m for m in messages if m.get("type") == "TRACE"), None
            )
            detail = (
                trace.get("trace", {}).get("error", {}).get("message")
                if trace else proc.stderr.strip()[-2000:]
            )
            raise RuntimeError(
                f"airbyte connector {self.argv} {args[0]} failed "
                f"(rc={proc.returncode}): {detail}"
            )
        return messages

    def spec(self) -> dict | None:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            for m in self._run(["spec"], td):
                if m.get("type") == "SPEC":
                    return m.get("spec")
        return None

    def discover(self) -> dict:
        import os
        import tempfile

        if self._catalog is not None:
            return self._catalog
        with tempfile.TemporaryDirectory() as td:
            cfg = os.path.join(td, "config.json")
            with open(cfg, "w") as f:
                json.dump(self.config, f)
            for m in self._run(["discover", "--config", cfg], td):
                if m.get("type") == "CATALOG":
                    self._catalog = m["catalog"]
                    return self._catalog
        raise RuntimeError(
            f"airbyte connector {self.argv} emitted no CATALOG on discover"
        )

    def configured_catalog(self) -> dict:
        catalog = self.discover()
        selected = []
        for stream in catalog.get("streams", []):
            name = stream.get("name")
            if self.streams is not None and name not in self.streams:
                continue
            supported = stream.get("supported_sync_modes") or ["full_refresh"]
            sync_mode = (
                "incremental" if "incremental" in supported else supported[0]
            )
            selected.append({
                "stream": stream,
                "sync_mode": sync_mode,
                "destination_sync_mode": "append",
            })
        if self.streams is not None:
            known = {s.get("name") for s in catalog.get("streams", [])}
            missing = [s for s in self.streams if s not in known]
            if missing:
                raise ValueError(
                    f"streams {missing} not found in discovered catalog "
                    f"(available: {sorted(known)})"
                )
        return {"streams": selected}

    def extract(self, state: Any | None):
        import os
        import tempfile

        configured = self.configured_catalog()
        with tempfile.TemporaryDirectory() as td:
            cfg = os.path.join(td, "config.json")
            cat = os.path.join(td, "catalog.json")
            with open(cfg, "w") as f:
                json.dump(self.config, f)
            with open(cat, "w") as f:
                json.dump(configured, f)
            args = ["read", "--config", cfg, "--catalog", cat]
            if state is not None:
                st = os.path.join(td, "state.json")
                with open(st, "w") as f:
                    json.dump(state, f)
                args += ["--state", st]
            for m in self._run(args, td):
                if m.get("type") in ("RECORD", "STATE"):
                    yield m


def _default_runner(config_file_path: str, streams: list[str]) -> AirbyteRunner:
    """Build a runner from a connection yaml. A source with ``exec_path``
    runs the connector executable directly through the full CLI protocol
    (``ExecutableAirbyteRunner`` — self-contained, no external deps);
    ``docker_image`` sources go through airbyte_serverless's
    DockerAirbyteSource (docker runtime absent here — gated), matching
    ``third_party/airbyte_serverless/sources.py``."""
    import yaml  # type: ignore[import-untyped]

    with open(config_file_path) as f:
        config = yaml.safe_load(f)
    source_config = config["source"]
    if "exec_path" in source_config or "executable" in source_config:
        return ExecutableAirbyteRunner(
            source_config.get("exec_path") or source_config["executable"],
            source_config.get("config", {}),
            streams=streams or None,
            env=source_config.get("env"),
        )
    try:
        from airbyte_serverless.sources import (  # type: ignore[import-not-found]
            DockerAirbyteSource,
        )
    except ImportError:
        unavailable(
            "pw.io.airbyte.read", "airbyte-serverless (plus a docker runtime)"
        )

    class _Runner:
        def __init__(self) -> None:
            self._source = DockerAirbyteSource(
                connector=source_config["docker_image"],
                config=source_config.get("config", {}),
                streams=",".join(streams) if streams else None,
            )

        def extract(self, state):
            for message in self._source.extract(state=state):
                yield (
                    message if isinstance(message, dict) else message.__dict__
                )

    return _Runner()


class AirbyteSource(RealtimeSource):
    """Runs ``extract`` every refresh interval, emitting RECORD messages as
    rows (single json ``data`` column by default — the reference's
    _AirbyteRecordSchema — or typed columns under ``schema=``), tracking
    STATE messages for incremental resume and diffing full-refresh
    streams against their previous snapshot."""

    # connector state: Airbyte cursors + full-refresh snapshots + row count
    STATE_FIELDS = (
        "_stream_states", "_global_state", "_legacy_only", "_snapshots",
        "_emitted",
    )

    def __init__(self, runner: AirbyteRunner, streams: list[str],
                 refresh_interval_s: float, mode: str,
                 sync_modes: dict[str, str], default_sync: str,
                 columns: list[str], fields: list[str] | None,
                 with_stream_col: bool):
        super().__init__(columns)
        self.runner = runner
        self.streams = list(streams)
        self.refresh_interval_s = refresh_interval_s
        self.mode = mode
        self.sync_modes = dict(sync_modes)
        self.default_sync = default_sync
        self.fields = fields  # None = raw json column
        self.with_stream_col = with_stream_col
        self._stream_states: dict[str, Any] = {}
        self._global_state: Any | None = None
        self._legacy_only = True
        #: full-refresh streams: content-key -> row tuple of the last run
        self._snapshots: dict[str, dict[int, tuple]] = {}
        self._emitted = 0
        self._next_poll = 0.0
        self._done = False

    # -- state plumbing ---------------------------------------------------

    def _absorb_state(self, state: Any) -> None:
        if isinstance(state, dict) and state.get("type") == "STREAM":
            desc = state.get("stream", {})
            name = desc.get("stream_descriptor", {}).get("name")
            if name is not None:
                self._stream_states[name] = desc.get("stream_state")
                self._legacy_only = False
                return
        if isinstance(state, dict) and state.get("type") == "GLOBAL":
            self._global_state = state.get("global")
            self._legacy_only = False
            return
        # legacy shape: the raw state blob
        self._global_state = state

    def _state_for_extract(self) -> Any:
        if self._legacy_only:
            return self._global_state
        out: dict[str, Any] = {"streams": dict(self._stream_states)}
        if self._global_state is not None:
            out["global"] = self._global_state
        return out

    # -- record shaping ---------------------------------------------------

    def _row_of(self, stream: str, data: dict) -> tuple:
        if self.fields is None:
            row: tuple = (json.dumps(data),)
        else:
            row = tuple(data.get(f) for f in self.fields)
        if self.with_stream_col:
            row = (stream,) + row
        return row

    def _sync_mode(self, stream: str) -> str:
        return self.sync_modes.get(stream, self.default_sync)

    def poll(self):
        from ..engine import keys as K
        from ..engine.delta import Delta, rows_to_columns

        now = _time.monotonic()
        if now < self._next_poll or self._done:
            return []
        self._next_poll = now + self.refresh_interval_s

        append_rows: list[tuple] = []
        refresh_pairs: list[tuple[str, tuple]] = []
        for msg in self.runner.extract(self._state_for_extract()):
            mtype = msg.get("type")
            if mtype == "RECORD":
                rec = msg["record"]
                stream = rec.get("stream", "")
                if self.streams and stream not in self.streams:
                    continue
                row = self._row_of(stream, rec.get("data", {}))
                if self._sync_mode(stream) == "full_refresh":
                    refresh_pairs.append((stream, row))
                else:
                    append_rows.append(row)
            elif mtype == "STATE":
                self._absorb_state(msg.get("state"))
        # one batched hash for the whole refresh set, like the append path
        refresh_rows: dict[str, dict[int, tuple]] = {}
        if refresh_pairs:
            rkeys = K.hash_values(refresh_pairs)
            for (stream, row), k in zip(refresh_pairs, rkeys):
                refresh_rows.setdefault(stream, {})[int(k)] = row
        if self.mode == "static":
            self._done = True

        out_rows: list[tuple] = []
        out_keys: list[int] = []
        out_diffs: list[int] = []
        if append_rows:
            start = self._emitted
            self._emitted += len(append_rows)
            keys = K.hash_values(
                [(start + i, r) for i, r in enumerate(append_rows)]
            )
            out_rows.extend(append_rows)
            out_keys.extend(int(k) for k in keys)
            out_diffs.extend([1] * len(append_rows))
        # full-refresh replace: diff this run's snapshot against the last.
        # Streams that returned ZERO records this run still diff (their
        # table is now empty → everything previously emitted retracts).
        for stream in set(refresh_rows) | set(self._snapshots):
            if self._sync_mode(stream) != "full_refresh":
                continue
            new_snap = refresh_rows.get(stream, {})
            old_snap = self._snapshots.get(stream, {})
            for k, row in old_snap.items():
                if k not in new_snap:
                    out_rows.append(row)
                    out_keys.append(k)
                    out_diffs.append(-1)
            for k, row in new_snap.items():
                if k not in old_snap:
                    out_rows.append(row)
                    out_keys.append(k)
                    out_diffs.append(1)
            self._snapshots[stream] = new_snap
        if not out_rows:
            return []
        import numpy as np

        return [Delta(
            keys=np.array(out_keys, dtype=np.uint64),
            data=rows_to_columns(out_rows, self.column_names),
            diffs=np.array(out_diffs, dtype=np.int64),
        )]

    def offset_state(self):
        return {
            "stream_states": self._stream_states,
            "global": self._global_state,
            "legacy_only": self._legacy_only,
            "snapshots": self._snapshots,
            "emitted": self._emitted,
        }

    def seek(self, state) -> None:
        if "state" in state and "stream_states" not in state:
            # pre-r4 offset shape
            self._global_state = state.get("state")
            self._emitted = int(state.get("emitted", 0))
            return
        self._stream_states = dict(state.get("stream_states", {}))
        self._global_state = state.get("global")
        self._legacy_only = bool(state.get("legacy_only", True))
        # offsets persist through json: int keys come back as strings and
        # row tuples as lists — normalize, or the first post-recovery poll
        # would spuriously retract+reinsert every unchanged row
        self._snapshots = {
            s: {int(k): tuple(v) for k, v in (m or {}).items()}
            for s, m in (state.get("snapshots") or {}).items()
        }
        self._emitted = int(state.get("emitted", 0))

    def is_finished(self) -> bool:
        return self._done


def read(config_file_path: str, streams: list[str], *, mode: str = "streaming",
         refresh_interval_ms: int = 60_000, name: str | None = None,
         schema: SchemaMetaclass | None = None,
         sync_mode: str | dict[str, str] = "incremental",
         _runner: AirbyteRunner | None = None, **kwargs: Any) -> Table:
    """Stream records from an Airbyte source.

    ``schema=`` projects record fields into typed columns (otherwise one
    json ``data`` column); ``sync_mode`` is ``"incremental"`` (append) or
    ``"full_refresh"`` (replace), globally or per stream via a dict.
    ``_runner`` injects any AirbyteRunner (tests use a fake emitting
    protocol messages)."""
    runner = (
        _runner if _runner is not None
        else _default_runner(config_file_path, streams)
    )
    if isinstance(sync_mode, dict):
        sync_modes, default_sync = dict(sync_mode), "incremental"
    else:
        sync_modes, default_sync = {}, sync_mode
    with_stream_col = len(streams) != 1
    if schema is not None and with_stream_col and "stream" in schema.column_names():
        raise ValueError(
            "schema must not define a column named 'stream': multi-stream "
            "reads add that column to carry the source stream name"
        )
    if schema is not None:
        fields: list[str] | None = schema.column_names()
        dtypes = {n: c.dtype for n, c in schema.columns().items()}
    else:
        fields = None
        dtypes = {"data": str}  # type: ignore[dict-item]
    columns = (["stream"] if with_stream_col else []) + (
        fields if fields is not None else ["data"]
    )

    def build():
        src = AirbyteSource(
            runner, streams, refresh_interval_ms / 1000.0, mode,
            sync_modes, default_sync, columns, fields, with_stream_col,
        )
        src.persistent_id = name
        return src

    if schema is not None:
        cols = {n: dtypes[n] for n in fields}  # type: ignore[union-attr]
        if with_stream_col:
            table_schema = schema_from_types(stream=str, **cols)
        else:
            table_schema = schema_from_types(**cols)
    else:
        if with_stream_col:
            table_schema = schema_from_types(stream=str, data=str)
        else:
            table_schema = schema_from_types(data=str)
    return Table("source", [], {"build": build}, table_schema, Universe())
