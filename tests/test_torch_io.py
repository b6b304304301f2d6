"""The port's file connectors (``pw.io.fs``, ``csv``, ``jsonlines``, ``plaintext``, the columnar
parser and the delivery-managed writers) against the JAX package's, on the CPU.

- Static reads: the reference cases of ``tests/test_ported_io.py`` (typed csv with a primary key,
  default and optional cells, a directory, a delimiter, jsonlines, plaintext by line and by file,
  raw bytes, ids across connectors) and a schemaless sniff, read by both packages from the same
  files: ids and values exact.
- The tail stream (``FsStreamSource``) polled directly, as ``tests/test_columnar_ingest.py``
  does: the promotion matrix, declared-float coercion, primary keys, malformed-input errors and
  chunked columnar against per-row parsing (the reference's pyarrow and numpy paths; the port
  has numpy's only), each arm of
  ``PATHWAY_INGEST_COLUMNAR`` in both packages: keys, values and dtypes exact, the same exception
  type and message.
- The tail stream with appended, partial and truncated lines, and the object stream (a modified
  and a deleted file), polled directly and through ``pw.run``: update streams compared as
  multisets of (id, row, diff) per file event (the packages' tick times differ).
- ``csv.write``, ``jsonlines.write`` and ``null.write``: a static input's output files byte for
  byte (the two packages' times agree there), a streaming input's rows and diffs.

Tolerance: none. Every streaming run has a time limit of its own (``torch_io_runs``).
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import time
from collections import Counter

import numpy as np
import pytest

import pathway_tpu as rpw
import pathway_tpu_torch as tpw
from torch_io_runs import Recorder, drive_events, run_bounded

PACKAGES = {"reference": rpw, "port": tpw}
RUN = {"reference": {}, "port": {"device": "cpu"}}


@pytest.fixture(autouse=True)
def _clean_graphs():
    rpw.G.clear()
    tpw.G.clear()
    yield
    rpw.G.clear()
    tpw.G.clear()


def _plain(v):
    return v.item() if isinstance(v, np.generic) else v


def _table(p, name: str, table) -> dict:
    """id -> row tuple of a table, computed by package ``p``."""
    ids, cols = p.debug.table_to_dicts(table, **RUN[name])
    names = table.column_names()
    return {int(k): tuple(_plain(cols[n][k]) for n in names) for k in ids}


def _both(build) -> dict:
    out = {}
    for name, p in PACKAGES.items():
        p.G.clear()
        t = build(p)
        out[name] = (t.column_names(), _table(p, name, t))
    assert out["port"] == out["reference"]
    return out["port"][1]


# -- static reads -------------------------------------------------------------------------------


def _pk_schema(p, **types):
    """A schema whose first column is the primary key."""
    cols = {}
    for i, (n, spec) in enumerate(types.items()):
        if isinstance(spec, tuple):
            dtype, default = spec
            cols[n] = p.column_definition(dtype=dtype, default_value=default)
        else:
            cols[n] = p.column_definition(dtype=spec, primary_key=i == 0)
    return p.schema_builder(cols)


STATIC = {
    "csv_pk": ("in.csv", "k,v\n1,foo\n2,bar\n3,baz\n",
               lambda p, d: p.io.csv.read(f"{d}/in.csv", schema=_pk_schema(p, k=int, v=str),
                                          mode="static")),
    "csv_default": ("in.csv", "k,v\na,42\nb,43\nc,\n",
                    lambda p, d: p.io.csv.read(f"{d}/in.csv", schema=_pk_schema(
                        p, k=str, v=(int, 0)), mode="static")),
    "csv_optional": ("in.csv", "k,v,w\na,1,x\nb,,y\nc,3,\n",
                     lambda p, d: p.io.csv.read(f"{d}/in.csv", schema=p.schema_from_types(
                         k=str, v=int | None, w=str), mode="static")),
    "csv_types": ("in.csv", "a,b,c,d\n1,2.5,true,x\n-7,1e3,no,\n0,-0.0,ON,z z\n",
                  lambda p, d: p.io.csv.read(f"{d}/in.csv", schema=p.schema_from_types(
                      a=int, b=float, c=bool, d=str), mode="static")),
    "csv_schemaless": ("in.csv", "a,b,c\n1,2.5,x\n3,,y\n-4,1e2,7z\n",
                       lambda p, d: p.io.csv.read(f"{d}/in.csv", mode="static")),
    "csv_directory": ({"1.csv": "k,v\na,1\n", "2.csv": "k,v\nb,2\nc,3\n"}, None,
                      lambda p, d: p.io.csv.read(d, schema=_pk_schema(p, k=str, v=int),
                                                 mode="static")),
    "dsv_delimiter": ("in.dsv", "k;v\na;1\nb;2\n",
                      lambda p, d: p.io.fs.read(f"{d}/in.dsv", format="dsv",
                                                schema=p.schema_from_types(k=str, v=int),
                                                csv_settings=p.io.csv.CsvParserSettings(
                                                    delimiter=";"), mode="static")),
    "jsonlines_optional": ("in.jsonl", '{"k": "a", "v": 1}\n{"k": "b"}\n\n{"k": "c", "v": 3}\n',
                           lambda p, d: p.io.jsonlines.read(f"{d}/in.jsonl", schema=_pk_schema(
                               p, k=str, v=(int | None, None)), mode="static")),
    "jsonlines_schemaless": ("in.jsonl", '{"a": 1, "b": "x", "c": [1, 2]}\n{"a": 2.5, "b": null}\n',
                             lambda p, d: p.io.jsonlines.read(f"{d}/in.jsonl", mode="static")),
    "plaintext": ("in.txt", "alpha\nbeta\n\ngamma\nalpha\n",
                  lambda p, d: p.io.plaintext.read(f"{d}/in.txt", mode="static")),
    "plaintext_by_file": ({"a.txt": "one\ntwo\n", "b.txt": "three"}, None,
                          lambda p, d: p.io.fs.read(d, format="plaintext_by_file",
                                                    mode="static")),
    "raw": ({"a.bin": "hello", "b.bin": "\x00\x01world"}, None,
            lambda p, d: p.io.fs.read(d, format="raw", mode="static")),
}


@pytest.mark.parametrize("case", sorted(STATIC))
def test_static_read_matches_reference(tmp_path, case):
    files, text, build = STATIC[case]
    if isinstance(files, str):
        files = {files: text}
    for fname, body in files.items():
        (tmp_path / fname).write_bytes(body.encode("latin-1"))
    rows = _both(lambda p: build(p, str(tmp_path)))
    assert rows


def test_static_csv_default_values_read_as_declared(tmp_path):
    (tmp_path / "in.csv").write_text("k,v\na,42\nb,43\nc,\n")
    rows = _both(lambda p: p.io.csv.read(str(tmp_path / "in.csv"),
                                         schema=_pk_schema(p, k=str, v=(int, 0)), mode="static"))
    assert sorted(rows.values()) == [("a", 42), ("b", 43), ("c", 0)]


def test_id_hashing_across_connectors(tmp_path):
    (tmp_path / "in.csv").write_text("key,value\n1,foo\n")
    (tmp_path / "in.jsonl").write_text('{"key": 1, "value": "foo"}\n')
    ids = {}
    for fmt in ("csv", "jsonlines"):
        ids[fmt] = set(_both(lambda p: getattr(p.io, fmt).read(
            str(tmp_path / ("in.csv" if fmt == "csv" else "in.jsonl")),
            schema=_pk_schema(p, key=int, value=str), mode="static")))
    assert ids["csv"] == ids["jsonlines"]


def test_binary_streaming_read_falls_through_to_the_static_read(tmp_path):
    """The example's call: neither streaming branch takes ``binary``, so both packages read the
    directory once, into a static table of ``data`` alone."""
    (tmp_path / "a.txt").write_text("first")
    (tmp_path / "b.md").write_text("# second")
    for name, p in PACKAGES.items():
        p.G.clear()
        t = p.io.fs.read(str(tmp_path), format="binary", mode="streaming", with_metadata=True)
        assert t._kind == "static", name
        assert t.column_names() == ["data"], name
    _both(lambda p: p.io.fs.read(str(tmp_path), format="binary", mode="streaming",
                                 with_metadata=True))


# -- the tail stream, polled directly -------------------------------------------------------


def _poll_delta(package, tmp_path, monkeypatch, *, columnar, text, format, types=None,
                schema=None, fname="data.in", assert_columnar=False, chunk=None):
    p = PACKAGES[package]
    fs = importlib.import_module(f"{p.__name__}.io.fs")
    monkeypatch.setenv("PATHWAY_INGEST_COLUMNAR", "1" if columnar else "0")
    if chunk is not None:
        monkeypatch.setenv("PATHWAY_INGEST_CHUNK", str(chunk))
    schema = schema(p) if schema is not None else p.schema_from_types(**types)
    path = tmp_path / f"{package}_{int(columnar)}_{fname}"
    path.write_text(text)
    src = fs.FsStreamSource(str(path), format, schema, schema.column_names(), autocommit_ms=None)
    per_row = fs.FsStreamSource._parse_line
    if assert_columnar:
        def boom(self, fpath, line):
            raise AssertionError("the per-row parser ran while the columnar plane was on")

        monkeypatch.setattr(fs.FsStreamSource, "_parse_line", boom)
    try:
        out = src.poll()
    finally:
        monkeypatch.setattr(fs.FsStreamSource, "_parse_line", per_row)
    assert len(out) == 1
    return out[0]


def _delta_rows(d) -> Counter:
    names = list(d.data)
    return Counter(zip(d.keys.tolist(), *[[_plain(v) for v in d.data[n]] for n in names],
                       d.diffs.tolist()))


def _assert_same_delta(a, b) -> None:
    assert list(a.data) == list(b.data)
    np.testing.assert_array_equal(a.keys, b.keys)
    for n in a.data:
        assert np.asarray(a.data[n]).dtype == np.asarray(b.data[n]).dtype, n
    assert _delta_rows(a) == _delta_rows(b)


PARITY_CASES = [
    ("csv", "name,age,score,ok\nalice,30,1.5,true\nbob,41,2.0,false\ncarol,0,-3.25,true\n",
     {"name": str, "age": int, "score": float, "ok": bool}),
    ("jsonlines", '{"name": "alice", "age": 30, "score": 1.5, "ok": true}\n'
                  '{"name": "bob", "age": 41, "score": 2.0, "ok": false}\n'
                  '{"name": "carol", "age": 0, "score": -3.25, "ok": true}\n',
     {"name": str, "age": int, "score": float, "ok": bool}),
    ("plaintext", "alpha\nbeta\ngamma\nalpha\n", {"data": str}),
]


@pytest.mark.parametrize("format,text,types", PARITY_CASES, ids=[c[0] for c in PARITY_CASES])
def test_fs_promotion_parity_matrix(tmp_path, monkeypatch, format, text, types):
    """Both arms of the columnar switch in both packages: the same keys, rows and dtypes; the
    port's per-row parser never runs on its columnar arm."""
    deltas = {(pk, col): _poll_delta(pk, tmp_path, monkeypatch, columnar=col, text=text,
                                     format=format, types=types,
                                     assert_columnar=col and pk == "port")
              for pk in PACKAGES for col in (True, False)}
    want = deltas[("reference", True)]
    for d in deltas.values():
        _assert_same_delta(d, want)


def test_csv_declared_float_coercion_keys(tmp_path, monkeypatch):
    keys = {}
    for tag, text in (("int", "x\n1\n2\n"), ("float", "x\n1.0\n2.5\n")):
        for package in PACKAGES:
            for columnar in (True, False):
                d = _poll_delta(package, tmp_path, monkeypatch, columnar=columnar, text=text,
                                format="csv", types={"x": float}, fname=f"{tag}.csv")
                assert np.asarray(d.data["x"]).dtype == np.float64
                keys[(tag, package, columnar)] = int(d.keys[0])
    assert len(set(keys.values())) == 1, keys


def test_csv_primary_key_parity(tmp_path, monkeypatch):
    def schema(p):
        return p.schema_builder({"id": p.column_definition(dtype=int, primary_key=True),
                                 "v": p.column_definition(dtype=str)})

    got = {}
    for package in PACKAGES:
        for columnar in (True, False):
            for tag, text in (("a", "id,v\n1,aa\n2,bb\n"), ("b", "id,v\n1,zz\n2,ww\n")):
                got[(package, columnar, tag)] = _poll_delta(
                    package, tmp_path, monkeypatch, columnar=columnar, text=text, format="csv",
                    schema=schema, fname=f"{tag}.csv")
    want = got[("reference", False, "a")].keys
    for d in got.values():  # the same ids whatever v holds
        np.testing.assert_array_equal(d.keys, want)


@pytest.mark.parametrize("format,text,types", [
    ("csv", "x\n1\nabc\n", {"x": int}),
    ("csv", "x,y\n1,2\n3\n", {"x": int, "y": int}),
    ("jsonlines", '{"x": 1}\n{"x": oops}\n', {"x": int}),
    ("jsonlines", '{"x": 1}\n[1, 2]\n', {"x": int}),
], ids=["csv-bad-int", "csv-short-row", "jsonlines-bad-line", "jsonlines-not-an-object"])
def test_malformed_input_error_parity(tmp_path, monkeypatch, format, text, types):
    errors = {}
    for package in PACKAGES:
        for columnar in (True, False):
            with pytest.raises(Exception) as exc:
                _poll_delta(package, tmp_path, monkeypatch, columnar=columnar, text=text,
                            format=format, types=types)
            errors[(package, columnar)] = (type(exc.value).__name__, str(exc.value))
    assert len(set(errors.values())) == 1, errors


def _mixed_csv(n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    lines = ["word,x,f,ok,note"]
    for i in range(n):
        note = "" if i % 97 == 5 else f'"a, {int(rng.integers(0, 9))}"'
        lines.append(f"w{int(rng.integers(0, 50))},{int(rng.integers(-10**6, 10**6))},"
                     f"{rng.standard_normal():.6g},{'true' if rng.random() < 0.5 else 'no'},"
                     f"{note}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("pyarrow", ["1", "0"])
def test_chunked_columnar_against_per_row(tmp_path, monkeypatch, pyarrow):
    """3,000 csv rows in chunks of 256 with optional cells that refuse a few chunks (the per-chunk
    fallback), quoted commas and bools: the columnar arm of each package equals the per-row
    arm of the reference, with the reference's csv chunks on pyarrow's path and on numpy's (the
    port reads ``PATHWAY_INGEST_PYARROW`` not at all: its chunks take numpy's)."""
    monkeypatch.setenv("PATHWAY_INGEST_PYARROW", pyarrow)
    text = _mixed_csv(3000, 4)

    def schema(p):
        return p.schema_from_types(word=str, x=int, f=float, ok=bool, note=str | None)

    want = _poll_delta("reference", tmp_path, monkeypatch, columnar=False, text=text,
                       format="csv", schema=schema, chunk=256)
    for package in PACKAGES:
        got = _poll_delta(package, tmp_path, monkeypatch, columnar=True, text=text,
                          format="csv", schema=schema, chunk=256)
        _assert_same_delta(got, want)
    assert len(want) == 3000


def test_jsonlines_chunk_with_mixed_int_float_refuses(tmp_path, monkeypatch):
    text = "".join(json.dumps({"v": (i if i % 3 else i + 0.5)}) + "\n" for i in range(40))
    want = _poll_delta("reference", tmp_path, monkeypatch, columnar=False, text=text,
                       format="jsonlines", types={"v": float}, chunk=8)
    got = _poll_delta("port", tmp_path, monkeypatch, columnar=True, text=text,
                      format="jsonlines", types={"v": float}, chunk=8)
    _assert_same_delta(got, want)


def _tail_events(package, tmp_path, monkeypatch, columnar: bool) -> list[Counter]:
    """Polls of a csv tail between file events: a first write, an append ending in a partial
    line, the line's completion, a truncation to fresh content."""
    p = PACKAGES[package]
    fs = importlib.import_module(f"{p.__name__}.io.fs")
    monkeypatch.setenv("PATHWAY_INGEST_COLUMNAR", "1" if columnar else "0")
    path = tmp_path / f"tail_{package}_{int(columnar)}.csv"
    schema = p.schema_from_types(w=str, n=int)
    src = fs.FsStreamSource(str(path), "csv", schema, ["w", "n"], autocommit_ms=None)
    out = []
    path.write_text("w,n\na,1\nb,2\n")
    out.append(src.poll())
    with open(path, "a") as f:
        f.write("c,3\nd,4\ne,")
    out.append(src.poll())
    with open(path, "a") as f:
        f.write("5\n")
    out.append(src.poll())
    out.append(src.poll())  # nothing new
    path.write_text("w,n\nz,9\n")  # shrunk: re-read from the start
    out.append(src.poll())
    return [sum((_delta_rows(d) for d in ds), Counter()) for ds in out]


def test_tail_stream_appends_partial_lines_and_truncation(tmp_path, monkeypatch):
    runs = {(pk, col): _tail_events(pk, tmp_path, monkeypatch, col)
            for pk in PACKAGES for col in (True, False)}
    want = runs[("reference", False)]
    assert [sum(c.values()) for c in want] == [2, 2, 1, 0, 1]
    for got in runs.values():
        assert got == want


def _object_events(package, tmp_path, monkeypatch) -> list[Counter]:
    """Polls of the object stream (``_LocalFsClient`` into ``ObjectScanSource``) between file
    events: two files, one modified, one deleted; the wall clock held still so ``seen_at`` and
    the ids agree across packages."""
    p = PACKAGES[package]
    fs = importlib.import_module(f"{p.__name__}.io.fs")
    scan = importlib.import_module(f"{p.__name__}.io._object_scanner")
    monkeypatch.setattr(scan._time, "time", lambda: 1_700_000_000.0)
    d = tmp_path / "objects"  # the same paths in both packages' runs: they enter the ids
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir()
    schema = p.schema_from_types(w=str, n=int)
    src = scan.ObjectScanSource(fs._LocalFsClient(str(d)), "csv", schema, ["w", "n"],
                                with_metadata=True, refresh_interval_s=0.0, autocommit_ms=None)
    out = []

    def write(name: str, body: str, mtime: int) -> None:
        (d / name).write_text(body)
        os.utime(d / name, ns=(mtime, mtime))

    def poll():
        time.sleep(0.001)
        ds = src.poll()
        rows = sum((_delta_rows(x) for x in ds), Counter())
        out.append(Counter({(k, *v[:2], json.loads(v[2])["size"], v[3]): c
                            for (k, *v), c in rows.items()}))

    write("a.csv", "w,n\na,1\nb,2\n", 10**18)
    write("b.csv", "w,n\nc,3\n", 10**18)
    poll()
    write("a.csv", "w,n\na,1\nb,20\nq,7\n", 2 * 10**18)
    poll()
    (d / "b.csv").unlink()
    poll()
    return out


def test_object_stream_modified_and_deleted_file(tmp_path, monkeypatch):
    got = _object_events("port", tmp_path, monkeypatch)
    want = _object_events("reference", tmp_path, monkeypatch)
    assert got == want
    assert [sum(key[-1] * c for key, c in ev.items()) for ev in got] == [3, 1, -1]
    assert sum(c for key, c in got[1].items() if key[-1] < 0) == 2  # a's old rows retracted


# -- streaming through pw.run ---------------------------------------------------------------


def _append(path, text: str):
    def action():
        with open(path, "a") as f:
            f.write(text)
    return action


@pytest.mark.parametrize("columnar", ["1", "0"])
def test_tail_stream_through_pw_run(tmp_path, monkeypatch, columnar):
    """A jsonlines file that grows while ``pw.run`` tails it: the raw table's updates per
    append, and a groupby count's, as multisets, equal in both packages."""
    monkeypatch.setenv("PATHWAY_INGEST_COLUMNAR", columnar)
    got = {}
    for name, p in PACKAGES.items():
        p.G.clear()
        path = tmp_path / f"{name}.jsonl"
        path.write_text("")
        t = p.io.jsonlines.read(str(path), schema=p.schema_from_types(w=str, n=int),
                                mode="streaming", autocommit_duration_ms=10)
        counts = t.groupby(p.this.w).reduce(p.this.w, c=p.reducers.count())
        raw, agg = Recorder(["w", "n"]), Recorder(["w", "c"])
        p.io.subscribe(t, on_change=raw)
        p.io.subscribe(counts, on_change=agg)
        events = [(_append(path, "".join(json.dumps({"w": f"w{i % 3}", "n": i}) + "\n"
                                         for i in range(s, s + 5))), 5) for s in (0, 5, 10)]
        drive_events(p, raw, events, timeout_s=60, **RUN[name])
        got[name] = (raw.multisets(), agg.multisets())
    assert got["port"][0] == got["reference"][0]
    assert sum(got["port"][1], Counter()) == sum(got["reference"][1], Counter())


def test_object_stream_through_pw_run(tmp_path):
    """``with_metadata=True`` in streaming: each file is an object; a modified file retracts
    its rows, a deleted file all of them. Rows and diffs per event, equal in both packages
    (the ids hold ``seen_at``, a wall-clock second, so they are held within each run: every
    retraction names an id inserted before)."""
    got = {}
    for name, p in PACKAGES.items():
        p.G.clear()
        d = tmp_path / name
        d.mkdir()
        t = p.io.fs.read(str(d), format="csv", schema=p.schema_from_types(w=str, n=int),
                         mode="streaming", with_metadata=True, autocommit_duration_ms=10)
        assert t.column_names() == ["w", "n", "_metadata"]
        rec = Recorder(["w", "n", "_metadata"])
        p.io.subscribe(t, on_change=rec)

        def write(fname: str, body: str, d=d):
            def action():
                (d / fname).write_text(body)
            return action

        events = [(write("a.csv", "w,n\na,1\nb,2\n"), 2),
                  (write("a.csv", "w,n\na,1\nb,20\nq,7\n"), 5),
                  (lambda d=d: (d / "a.csv").unlink(), 3)]
        per_event = drive_events(p, rec, events, timeout_s=60, **RUN[name])
        live: Counter = Counter()
        for ev in per_event:
            for (key, _row, diff), c in ev.items():
                live[key] += diff * c
                assert live[key] >= 0, "a retraction of an id never inserted"
        assert not +live
        got[name] = [Counter({(row[0], row[1], json.loads(row[2])["path"][len(str(d)):], diff): c
                              for (_k, row, diff), c in ev.items()}) for ev in per_event]
    assert got["port"] == got["reference"]


# -- writers ------------------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["csv", "jsonlines"])
def test_writers_static_input_byte_for_byte(tmp_path, fmt):
    """A static table with ints, floats, strings, bools, bytes and None through
    ``csv.write``/``jsonlines.write``: the same bytes from both packages (both stamp time 0)."""
    rows = [(1, 2.5, "x", True, b"ab", None), (2, -0.0, "y, z", False, b"\xff", 3),
            (3, 1e300, 'q"uote', True, b"", 4)]
    out = {}
    for name, p in PACKAGES.items():
        p.G.clear()
        t = p.debug.table_from_rows(p.schema_from_types(
            a=int, f=float, s=str, b=bool, raw=bytes, o=int | None), rows)
        path = tmp_path / f"{name}.out"
        getattr(p.io, fmt).write(t, str(path))
        run_bounded(p, 60, **RUN[name])
        out[name] = path.read_bytes()
    assert out["port"] == out["reference"]
    lines = out["port"].decode().splitlines()
    assert len(lines) == 3 + (fmt == "csv")


def test_csv_write_of_a_stream_rows_and_diffs(tmp_path):
    """A growing plaintext file counted by word and written with ``csv.write``: the rows and
    diffs of the output (without its time column) equal in both packages, and the last row per
    word holds the final count."""
    got = {}
    for name, p in PACKAGES.items():
        p.G.clear()
        src = tmp_path / f"{name}.txt"
        src.write_text("")
        t = p.io.plaintext.read(str(src), mode="streaming", autocommit_duration_ms=10)
        counts = t.groupby(p.this.data).reduce(p.this.data, c=p.reducers.count())
        out = tmp_path / f"{name}.csv"
        p.io.csv.write(counts, str(out))
        rec = Recorder(["data"])
        p.io.subscribe(t, on_change=rec)
        words = [f"w{i % 4}" for i in range(24)]
        events = [(_append(src, "".join(w + "\n" for w in words[s:s + 8])), 4)
                  for s in (0, 8, 16)]
        drive_events(p, rec, events, timeout_s=60, **RUN[name])
        lines = out.read_text().splitlines()
        assert lines[0] == "data,c,time,diff"
        body = [ln.split(",") for ln in lines[1:]]
        got[name] = Counter((w, int(c), int(d)) for w, c, _t, d in body)
        last = {}
        for w, c, _t, d in body:
            if int(d) > 0:
                last[w] = int(c)
        assert last == dict(Counter(words))
    assert got["port"] == got["reference"]


def test_null_write_delivers_every_row(tmp_path):
    from pathway_tpu_torch.io.delivery import _reset_stats_for_tests, sink_stats_snapshot

    _reset_stats_for_tests()
    t = tpw.debug.table_from_rows(tpw.schema_from_types(a=int), [(i,) for i in range(10)])
    tpw.io.null.write(t)
    run_bounded(tpw, 60, device="cpu")
    assert sink_stats_snapshot()["null"]["delivered_rows_total"] == 10
    _reset_stats_for_tests()
