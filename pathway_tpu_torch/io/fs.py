"""``pw.io.fs`` — filesystem connector (csv/json/plaintext/binary).

Re-design of ``python/pathway/io/fs`` + the Rust filesystem scanner/parsers
(``src/connectors/posix_like.rs``, ``data_format.rs`` DsvParser :500,
JsonLinesParser :1443). Static mode reads files at build time; streaming
mode (directory watching) arrives with the realtime executor loop.

Copy of ``pathway_tpu/io/fs.py``. The tail stream persists its per-file byte
offsets (``offset_state``/``seek``: only bytes delivered to the engine, so a
resumed stream re-reads neither a counted row nor a partial last line) and
hands each chunk's ``Delta`` to the engine directly, without the reference's
connector-frame wrap and unwrap (the port has no cross-process path).
``write`` goes through the port's ``io/delivery.py``, transactional under
persistence.
As in the reference, ``format="binary"`` has no streaming branch and reads the
directory once, at build time (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import csv as _csv
import glob
import json
import os
from typing import Any

from ..engine.executor import RealtimeSource
from ..internals import dtype as dt
from ..internals.parse_graph import G
from ..internals.schema import SchemaMetaclass, schema_from_types
from ..internals.table import Table
from ..internals.table_io import rows_to_table


def _paths_of(path: str | os.PathLike) -> list[str]:
    path = os.fspath(path)
    if os.path.isdir(path):
        return sorted(
            os.path.join(root, f)
            for root, _, files in os.walk(path)
            for f in files
        )
    matched = sorted(glob.glob(path))
    return matched if matched else [path]


def _convert(value: str, col: Any) -> Any:
    dtype = col.dtype if hasattr(col, "dtype") else col
    u = dt.unoptionalize(dtype)
    if value == "":
        # an empty cell takes the schema default when one is declared
        # (reference test_io.py:458 test_csv_default_values), else None
        # for optional columns
        if getattr(col, "has_default", False):
            return col.default_value
        if dtype.is_optional:
            return None
    if u == dt.INT:
        return int(value)
    if u == dt.FLOAT:
        return float(value)
    if u == dt.BOOL:
        return value.strip().lower() in ("true", "1", "yes", "on")
    return value


class FsStreamSource(RealtimeSource):
    """Directory/glob watcher: polls for new files and appended lines,
    emitting one committed batch per poll round.

    Re-design of the Rust posix scanner + parser thread
    (``src/connectors/posix_like.rs``, ``scanner/filesystem``): offsets are
    (path → bytes consumed), which is this source's ``OffsetAntichain``
    (``src/connectors/offset.rs``) for persistence seek/resume. Each poll
    reads only the appended tail (stat + seek), never the whole file; a
    shrunk file (truncate/rotate) resets its offset and is re-read.
    """

    def __init__(
        self,
        path: str,
        format: str,
        schema: SchemaMetaclass | None,
        names: list[str],
        delimiter: str = ",",
        autocommit_ms: int | None = 1500,
    ):
        super().__init__(list(names))
        self.path = path
        self.format = format
        self.fschema = schema
        self.names = list(names)
        self.delimiter = delimiter
        self.autocommit_ms = autocommit_ms
        #: bytes actually delivered to the engine (the persisted offset);
        #: bytes parsed into _pending but not yet emitted stay in _staged so
        #: a checkpoint never covers input the snapshot doesn't contain
        self._consumed: dict[str, int] = {}
        self._staged: dict[str, int] = {}
        self._headers: dict[str, list[str]] = {}
        self._pending: list[tuple] = []
        #: columnar-parsed chunks awaiting emission: (path, columns, n).
        #: Keys are derived at EMISSION time (poll), like the dict path —
        #: a truncation dropping staged chunks must not have registered
        #: key pairs for rows that never ship
        self._pending_cols: list[tuple[str, dict, int]] = []
        self._plan: list | None = None  # lazy columnar csv parse plan
        self._last_emit: float | None = None  # None = emit first batch now

    # -- persistence protocol --

    def offset_state(self):
        return {"files": dict(self._consumed)}

    def seek(self, state) -> None:
        self._consumed = {str(k): int(v) for k, v in state.get("files", {}).items()}
        self._staged = {}
        self._pending = []
        self._pending_cols = []
        # headers live before the persisted offsets — recover them
        for fpath in list(self._consumed):
            self._load_header(fpath)

    # -- polling --

    def _load_header(self, fpath: str) -> bool:
        if self.format not in ("csv", "dsv") or fpath in self._headers:
            return True
        try:
            with open(fpath, "rb") as f:
                first = f.readline()
        except OSError:
            return False
        if not first.endswith(b"\n"):
            return False  # header not fully written yet
        self._headers[fpath] = next(
            _csv.reader([first.decode("utf-8").rstrip("\r\n")],
                        delimiter=self.delimiter)
        )
        # a fresh file starts past its header line
        if self._consumed.get(fpath, 0) < len(first):
            self._consumed[fpath] = len(first)
        return True

    def _parse_line(self, fpath: str, line: str):
        if self.format in ("csv", "dsv"):
            header = self._headers[fpath]
            rec = dict(zip(header, next(_csv.reader([line], delimiter=self.delimiter))))
            if self.fschema is not None:
                return tuple(
                    _convert(rec.get(n, ""), self.fschema.columns()[n])
                    for n in self.names
                )
            return tuple(_auto(rec.get(n, "")) for n in self.names)
        if self.format in ("json", "jsonlines"):
            obj = json.loads(line)
            return tuple(obj.get(n) for n in self.names)
        return (line,)  # plaintext

    def _parse_chunk(self, fpath: str, lines: list[str]):
        """Columnar parse of one chunk of raw lines → (columns, n), or
        :class:`columnar.ParseRefusal` when bit-parity with
        ``_parse_line`` cannot be guaranteed for this chunk."""
        from . import columnar as _col

        if self.format in ("csv", "dsv"):
            if self.fschema is None:
                raise _col.ParseRefusal("schemaless csv (_auto per cell)")
            if self._plan is None:
                self._plan = _col.csv_plan(self.fschema, self.names)
            return _col.parse_csv_chunk(
                lines, self._headers[fpath], self._plan, self.delimiter
            )
        if self.format in ("json", "jsonlines"):
            return _col.parse_json_chunk(lines, self.names)
        if self.format == "plaintext" and len(self.names) == 1:
            return _col.parse_plaintext_chunk(lines, self.names[0])
        raise _col.ParseRefusal(f"no columnar reader for {self.format!r}")

    def _ingest_lines(self, fpath: str, lines: list[str]) -> None:
        """Route freshly scanned lines into the parse staging area:
        columnar chunks when the columnar plane is on, the per-line dict
        path otherwise — and per CHUNK on any parse refusal (same
        values, same keys, same exceptions as the dict path)."""
        import time as _time

        from . import columnar as _col
        from .python import _accrue, _stage_sinks

        stage = _stage_sinks(f"fs-{self.format}")
        if not _col.enabled():
            t0 = _time.perf_counter_ns()
            for line in lines:
                self._pending.append((fpath, self._parse_line(fpath, line)))
            if stage is not None:
                _accrue(stage, "parse_ns", _time.perf_counter_ns() - t0)
            return
        step = _col.chunk_rows()
        for i in range(0, len(lines), step):
            sub = lines[i:i + step]
            t0 = _time.perf_counter_ns()
            try:
                data, n = self._parse_chunk(fpath, sub)
            except _col.ParseRefusal:
                # per-batch fallback: re-parse exactly this chunk row by
                # row — malformed cells raise here, where they always did
                for line in sub:
                    self._pending.append(
                        (fpath, self._parse_line(fpath, line))
                    )
                if stage is not None:
                    _accrue(stage, "parse_ns", _time.perf_counter_ns() - t0)
                continue
            if stage is not None:
                _accrue(stage, "parse_ns", _time.perf_counter_ns() - t0)
            self._pending_cols.append((fpath, data, n))

    def _scan(self) -> None:
        """Read appended tails of all watched files into _pending."""
        for fpath in _paths_of(self.path):
            if not os.path.isfile(fpath):
                continue
            try:
                size = os.stat(fpath).st_size
            except OSError:
                continue
            start = self._staged.get(fpath, self._consumed.get(fpath, 0))
            if size < start:
                # truncated/rotated — re-read from scratch; drop unemitted
                # rows parsed from the pre-truncation content
                self._consumed.pop(fpath, None)
                self._staged.pop(fpath, None)
                self._headers.pop(fpath, None)
                self._pending = [(p, r) for p, r in self._pending if p != fpath]
                self._pending_cols = [
                    (p, d, n) for p, d, n in self._pending_cols if p != fpath
                ]
                start = 0
            if not self._load_header(fpath):
                continue
            start = max(start, self._consumed.get(fpath, 0))
            if size <= start:
                continue
            try:
                with open(fpath, "rb") as f:
                    f.seek(start)
                    chunk = f.read()
            except OSError:
                continue
            # only consume complete (newline-terminated) lines; a partial
            # tail stays for the next poll
            end = chunk.rfind(b"\n")
            if end < 0:
                continue
            lines = [
                stripped
                for line in chunk[:end].decode("utf-8").split("\n")
                if (stripped := line.rstrip("\r")).strip()
            ]
            if lines:
                self._ingest_lines(fpath, lines)
            self._staged[fpath] = start + end + 1

    def poll(self):
        import time as _time

        from ..engine import keys as K
        from ..engine.delta import Delta, concat_deltas, rows_to_columns
        from .python import _accrue, _stage_sinks

        self._scan()
        if not self._pending and not self._pending_cols:
            return []
        now = _time.monotonic()
        window_open = (
            self._last_emit is None
            or self.autocommit_ms is None
            or (now - self._last_emit) * 1000.0 >= self.autocommit_ms
        )
        if not window_open:
            return []
        stage = _stage_sinks(f"fs-{self.format}")
        pk = (
            self.fschema.primary_key_columns()
            if self.fschema is not None
            else None
        )
        key_names = list(pk) if pk else list(self.names)
        deltas: list[Delta] = []
        total = 0
        if self._pending:
            rows = [r for _, r in self._pending]
            self._pending = []
            h0 = _time.perf_counter_ns()
            if pk:
                idx = [self.names.index(p) for p in pk]
                keys = K.hash_values([tuple(r[i] for i in idx) for r in rows])
            else:
                keys = K.hash_values(rows)
            h1 = _time.perf_counter_ns()
            deltas.append(Delta(keys=keys, data=rows_to_columns(rows, self.names)))
            if stage is not None:
                _accrue(stage, "hash_ns", h1 - h0)
                _accrue(stage, "delta_ns", _time.perf_counter_ns() - h1)
            total += len(rows)
        chunks, self._pending_cols = self._pending_cols, []
        for _fpath, data, n in chunks:
            # one fused native BLAKE2b pass over the parsed column
            # buffers — bit-identical to hash_values over the row tuples
            h0 = _time.perf_counter_ns()
            keys = K.mix_columns_fused([data[c] for c in key_names], n)
            h1 = _time.perf_counter_ns()
            d = Delta(keys=keys, data=data)
            d.keys_content_cols = tuple(key_names)
            deltas.append(d)
            if stage is not None:
                _accrue(stage, "hash_ns", h1 - h0)
                _accrue(stage, "delta_ns", _time.perf_counter_ns() - h1)
            total += n
        self._consumed.update(self._staged)  # rows now delivered → offset moves
        self._staged.clear()
        self._last_emit = now
        t0 = _time.perf_counter_ns()
        out = (
            deltas[0]
            if len(deltas) == 1
            else concat_deltas(deltas, self.names)
        )
        if stage is not None:
            if len(deltas) > 1:
                _accrue(stage, "delta_ns", _time.perf_counter_ns() - t0)
            _accrue(stage, "rows", total)
            _accrue(stage, "flushes", 1)
        return [out]

    def is_finished(self) -> bool:
        return False  # watches forever (stop via pw.request_stop)


class _LocalFsClient:
    """ObjectStoreClient over the local filesystem (reference
    ``posix_like.rs``): each file is an object versioned by
    (mtime_ns, size), so the shared scanner's modified/deleted-object
    retraction semantics apply to plain directories."""

    def __init__(self, path: str):
        self._path = path

    def list_objects(self):
        from ._object_scanner import ObjectMeta

        out = []
        for p in _paths_of(self._path):
            if not os.path.isfile(p):
                continue  # glob patterns can match directories
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append(ObjectMeta(
                key=p,
                version=f"{st.st_mtime_ns}:{st.st_size}",
                size=st.st_size,
                modified_at=st.st_mtime,
            ))
        return out

    def read_object(self, key: str) -> bytes:
        with open(key, "rb") as f:
            return f.read()


def read(
    path: str | os.PathLike,
    *,
    format: str = "csv",
    schema: SchemaMetaclass | None = None,
    mode: str = "streaming",
    csv_settings: Any = None,
    json_field_paths: dict[str, str] | None = None,
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    if format == "raw":
        format = "binary"  # reference alias (io/fs raw == whole-file bytes)
    if (
        mode == "streaming"
        and with_metadata
        and format in ("csv", "dsv", "json", "jsonlines", "plaintext")
    ):
        # object semantics (the reference's posix_like scanner): each file
        # is one object — a modified file retracts its old rows and inserts
        # the new version's, a deleted file retracts everything, and every
        # row carries a _metadata column. The default (tail) path below is
        # the append-log fast lane.
        from .s3 import object_source_table

        spath = os.fspath(path)
        delimiter = getattr(csv_settings, "delimiter", ",") if csv_settings else ","
        if format == "plaintext":
            schema = schema or schema_from_types(data=str)
        if schema is None:
            probe = read(spath, format=format, schema=None, mode="static",
                         csv_settings=csv_settings)
            schema = probe.schema
            if not schema.column_names():
                raise ValueError(
                    f"pw.io.fs.read({spath!r}, mode='streaming'): no files "
                    "to infer columns from yet — pass schema= explicitly"
                )
        return object_source_table(
            _LocalFsClient(spath), format, schema,
            mode="streaming", with_metadata=True,
            refresh_interval_ms=1000,
            autocommit_duration_ms=autocommit_duration_ms,
            name=name, delimiter=delimiter,
        )
    if mode == "streaming" and format in ("csv", "dsv", "json", "jsonlines", "plaintext"):
        from ..internals.parse_graph import Universe

        spath = os.fspath(path)
        delimiter = getattr(csv_settings, "delimiter", ",") if csv_settings else ","
        if format in ("plaintext",):
            schema = schema or schema_from_types(data=str)
        if schema is not None:
            names = schema.column_names()
        else:
            # sniff columns from whatever exists now
            probe = read(spath, format=format, schema=None, mode="static",
                         csv_settings=csv_settings)
            names = probe.column_names()
            schema = probe.schema
            if not names:
                raise ValueError(
                    f"pw.io.fs.read({spath!r}, mode='streaming'): no files to "
                    "infer columns from yet — pass schema= explicitly"
                )
        use_schema = schema

        def build():
            src = FsStreamSource(
                spath, format, use_schema, names, delimiter,
                autocommit_ms=autocommit_duration_ms,
            )
            src.persistent_id = name
            return src

        return Table("source", [], {"build": build}, use_schema, Universe())
    rows: list[tuple] = []
    names: list[str]
    if format in ("csv", "dsv"):
        delimiter = getattr(csv_settings, "delimiter", ",") if csv_settings else ","
        names = schema.column_names() if schema is not None else []
        for p in _paths_of(path):
            with open(p, newline="") as f:
                reader = _csv.DictReader(f, delimiter=delimiter)
                if not names:
                    names = list(reader.fieldnames or [])
                for rec in reader:
                    if schema is not None:
                        rows.append(tuple(
                            _convert(rec[n], schema.columns()[n]) for n in names
                        ))
                    else:
                        rows.append(tuple(_auto(rec[n]) for n in names))
    elif format in ("json", "jsonlines"):
        names = schema.column_names() if schema is not None else []
        for p in _paths_of(path):
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    obj = json.loads(line)
                    if not names:
                        names = list(obj.keys())
                    rows.append(tuple(obj.get(n) for n in names))
    elif format in ("plaintext", "plaintext_by_file"):
        names = ["data"]
        for p in _paths_of(path):
            if format == "plaintext_by_file":
                with open(p) as f:
                    rows.append((f.read(),))
            else:
                with open(p) as f:
                    for line in f:
                        rows.append((line.rstrip("\n"),))
        if schema is None:
            schema = schema_from_types(data=str)
    elif format == "binary":
        names = ["data"]
        for p in _paths_of(path):
            with open(p, "rb") as f:
                rows.append((f.read(),))
        if schema is None:
            schema = schema_from_types(data=bytes)
    else:
        raise ValueError(f"unknown format {format!r}")

    id_from = schema.primary_key_columns() if schema is not None else None
    return rows_to_table(names, rows, schema=schema, id_from=id_from)


class _FsSinkAdapter:
    """Transactional file writer (the reference FileWriter +
    DsvFormatter/JsonLinesFormatter, made exactly-once): the resume token
    is the byte position of the last ACKED batch — ``open`` truncates a
    recovered file back to it (a kill mid-write leaves a torn tail past
    the token; it is cut before new bytes land) and ``rollback`` does the
    same within a run, so retries after a torn write never double rows."""

    def __init__(self, filename: str, format: str, names: list[str]):
        self.filename = filename
        self.format = format
        self.names = names
        self._raw: Any = None
        self._f: Any = None
        self._writer: Any = None
        #: byte position writes resume from after a rollback: the last
        #: ACKED batch's end (or the post-header position) — NOT the last
        #: write's end, which a torn attempt may have advanced
        self._acked_pos = 0
        from .delivery import _env_f

        self._fsync = _env_f("PATHWAY_SINK_FSYNC", 1.0) > 0

    def open(self, resume_token: Any) -> None:
        import io as _io

        resume = (
            int(resume_token)
            if resume_token is not None and os.path.exists(self.filename)
            else None
        )
        self._raw = open(self.filename, "r+b" if resume is not None else "w+b")
        # text layer for csv/json rendering; byte positions come from the
        # binary layer (text-mode tell() cookies are not truncate() args)
        self._f = _io.TextIOWrapper(self._raw, encoding="utf-8", newline="")
        if self.format == "csv":
            self._writer = _csv.writer(self._f)
        if resume is not None:
            self._raw.truncate(resume)
            self._raw.seek(resume)
            self._acked_pos = resume
            return
        if self.format == "csv":
            self._writer.writerow(self.names + ["time", "diff"])
        self._f.flush()
        self._acked_pos = self._raw.tell()

    def write_batch(self, batch: Any) -> int:
        cols = [batch.delta.data[n] for n in self.names]
        if self.format == "csv":
            self._writer.writerows(
                list(vals) + [batch.time, int(diff)]
                for vals, diff in zip(zip(*cols), batch.delta.diffs)
            )
        else:
            for vals, diff in zip(zip(*cols), batch.delta.diffs):
                obj = {n: _jsonable(v) for n, v in zip(self.names, vals)}
                obj["time"] = batch.time
                obj["diff"] = int(diff)
                self._f.write(json.dumps(obj) + "\n")
        self._f.flush()
        if self._fsync:
            os.fsync(self._raw.fileno())
        return self._raw.tell()

    def rollback(self, resume_token: Any = None) -> None:
        if self._raw is None:
            return
        pos = (
            int(resume_token) if resume_token is not None else self._acked_pos
        )
        self._f.flush()
        self._raw.truncate(pos)
        self._raw.seek(pos)

    def on_timeout(self) -> None:
        """A watchdog-abandoned write thread may still be inside
        ``write_batch`` on this handle: close it so the zombie's next
        write fails on a closed fd instead of interleaving bytes with
        the retry's reopened file (delivery reopens via ``open`` with
        the last acked token, which truncates whatever the zombie
        managed to push)."""
        try:
            if self._f is not None:
                self._f.close()
        except Exception:
            pass
        self._raw = self._f = self._writer = None

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


def write(table: Table, filename: str | os.PathLike, *, format: str = "csv",
          name: str | None = None, retry_policy: Any = None,
          **kwargs: Any) -> None:
    """Write the table's update stream to a file (time/diff columns
    appended). Rides the transactional delivery layer (``io/delivery``):
    with persistence on, batches are acked against the committed frontier
    and the file recovers exactly-once across crashes."""
    from .delivery import deliver

    filename = os.fspath(filename)
    names = table.column_names()

    def adapter():
        return _FsSinkAdapter(filename, format, names)

    deliver(
        table, adapter,
        name=name,
        default_name=f"fs-{os.path.basename(filename)}",
        retry_policy=retry_policy,
        meta={"path": filename},
    )


def _jsonable(v: Any) -> Any:
    import numpy as np

    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return v


def _auto(v: str) -> Any:
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v
