"""The port's connector wire frame (``parallel/frames.py``) against the JAX package's, on the CPU.

- Frames that the two packages encode from the same seeded columns are equal byte for byte
  (a ``Delta`` section, a mesh column section, a pickled section, a control frame), and each
  package decodes the other's frame to the same arrays.
- A truncated or garbled buffer raises ``CorruptFrame`` in both, at the same cut.
- In process, ``connector_frame`` carries the ``Delta`` by reference; an encoded frame opens to an
  equal ``Delta``.
- The port's ``io/python.py`` ships a columnar batch as a connector frame and opens it in the
  engine-side poll by reference, with the reference's keys.

Tolerance: none; bytes, arrays and keys are compared exactly.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")


def _mods(package: str):
    return (importlib.import_module(f"{package}.parallel.frames"),
            importlib.import_module(f"{package}.engine.delta").Delta)


def _columns(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    words = np.empty(n, dtype=object)
    words[:] = [f"w{int(i)}" for i in rng.integers(0, 50, n)]
    return {
        "x": rng.integers(-2**40, 2**40, n, dtype=np.int64),
        "f": rng.standard_normal(n),
        "h": rng.standard_normal(n).astype(np.float32),
        "b": rng.random(n) < 0.5,
        "t": (np.arange(n, dtype=np.int64) * 1_000_003).astype("datetime64[ns]"),
        "word": words,
    }


def _delta(package: str, seed: int, n: int):
    _frames, Delta = _mods(package)
    rng = np.random.default_rng(seed + 1)
    return Delta(keys=rng.integers(0, 2**63, n, dtype=np.uint64), data=_columns(seed, n),
                 diffs=rng.choice(np.array([-1, 1, 2], dtype=np.int64), n))


def _frame(package: str, seed: int, n: int) -> bytes:
    frames, _ = _mods(package)
    per_dst = {
        0: _delta(package, seed, n),
        3: (7, {"a": np.arange(n, dtype=np.int64), "s": _columns(seed, n)["word"]}),
        5: {"not": ["a", "column", "set"]},
    }
    chunks, total = frames.encode_frame(("edge", 4), 11, 2, per_dst, ctx=("run", 9))
    buf = b"".join(bytes(c) for c in chunks)
    assert len(buf) == total
    return buf


def _assert_delta_equal(a, b) -> None:
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.diffs, b.diffs)
    assert list(a.data) == list(b.data)
    for c in a.data:
        assert a.data[c].dtype == b.data[c].dtype, c
        np.testing.assert_array_equal(a.data[c], b.data[c])


@pytest.mark.parametrize("n", [0, 1, 37, 1000])
def test_frames_byte_equal_across_packages(n):
    theirs, ours = (_frame(p, n + 5, n) for p in PACKAGES)
    assert ours == theirs
    frames_t, _ = _mods("pathway_tpu")
    frames_o, _ = _mods("pathway_tpu_torch")
    assert frames_o.encode_control(("ping", 3, [1, 2])) == frames_t.encode_control(
        ("ping", 3, [1, 2]))
    for decode, buf in ((frames_o.decode_frame, theirs), (frames_t.decode_frame, ours)):
        tag, channel, tick, src, per_dst, ctx = decode(bytearray(buf))
        assert (tag, channel, tick, src, ctx) == ("x", ("edge", 4), 11, 2, ("run", 9))
        assert sorted(per_dst) == [0, 3, 5]
        _assert_delta_equal(per_dst[0], _delta("pathway_tpu", n + 5, n))
        src_tag, cols = per_dst[3]
        assert src_tag == 7 and list(cols) == ["a", "s"]
        np.testing.assert_array_equal(cols["a"], np.arange(n))
        assert per_dst[5] == {"not": ["a", "column", "set"]}


def _corrupt_error(package: str, buf: bytes) -> str:
    frames, _ = _mods(package)
    with pytest.raises(frames.CorruptFrame) as exc:
        frames.decode_frame(bytearray(buf))
    return str(exc.value)


@pytest.mark.parametrize("cut", [1, 5, 23, 60, 200, -40, -1])
def test_truncated_frame_is_corrupt_in_both(cut):
    buf = _frame("pathway_tpu_torch", 3, 50)
    errors = [_corrupt_error(p, buf[:cut]) for p in PACKAGES]
    assert errors[0] == errors[1]


def _garbled(buf: bytes) -> dict:
    """Frames with one field broken: the tag, the destination count, a column's dtype, a column's
    byte count, a trailing byte."""
    out = {"kind": bytes([7]) + buf[1:], "trailing": buf + b"\x00"}
    b = bytearray(buf)
    b[14:18] = (1 << 21).to_bytes(4, "big")  # n_dsts
    out["n_dsts"] = bytes(b)
    i = buf.index(b"<i8")
    out["dtype"] = buf[:i] + b"<q8" + buf[i + 3:]
    j = buf.index(b"<f8") + 3  # the u64 byte count after the first float column's dtype
    b = bytearray(buf)
    b[j:j + 8] = (int.from_bytes(buf[j:j + 8], "big") - 8).to_bytes(8, "big")
    out["nbytes"] = bytes(b)
    return out


@pytest.mark.parametrize("field", ["kind", "trailing", "n_dsts", "dtype", "nbytes"])
def test_garbled_frame_is_corrupt_in_both(field):
    buf = _frame("pathway_tpu", 4, 30)
    assert buf == _frame("pathway_tpu_torch", 4, 30)
    bad = _garbled(buf)[field]
    errors = [_corrupt_error(p, bad) for p in PACKAGES]
    assert errors[0] == errors[1]


@pytest.mark.parametrize("package", PACKAGES)
def test_connector_frame_passes_by_reference(package):
    frames, _ = _mods(package)
    d = _delta(package, 8, 64)
    frame = frames.connector_frame(d)
    assert frames.open_connector_frame(frame) is d
    chunks, _ = frames.encode_frame(frame[1], frame[2], frame[3], frame[4])
    opened = frames.open_connector_frame(b"".join(bytes(c) for c in chunks))
    assert opened is not d
    _assert_delta_equal(opened, d)
    with pytest.raises(AssertionError, match="decodable"):
        frames.connector_frame({"rows": [1, 2]})


def test_connector_frames_of_both_packages_encode_equal():
    frames_t, _ = _mods("pathway_tpu")
    frames_o, _ = _mods("pathway_tpu_torch")
    ft = frames_t.connector_frame(_delta("pathway_tpu", 9, 100))
    fo = frames_o.connector_frame(_delta("pathway_tpu_torch", 9, 100))
    enc = [b"".join(bytes(c) for c in f.encode_frame(*fr[1:5])[0])
           for f, fr in ((frames_t, ft), (frames_o, fo))]
    assert enc[0] == enc[1]


def _python_batch(package: str, words: list, xs: list):
    """The port's (or the reference's) ``PythonSubjectSource`` pre-building one columnar batch on
    the producer's side, as ``start()`` installs it, then the engine-side poll's delta."""
    py = importlib.import_module(f"{package}.io.python")
    dt = importlib.import_module(f"{package}.internals.dtype")
    subject = py.ConnectorSubject()
    src = py.PythonSubjectSource(subject, ["word", "x"], {}, None, autocommit_ms=None,
                                 dtypes={"word": dt.STR, "x": dt.INT})
    subject._batch_builder = src._prebuild_batch
    subject.next_batch({"word": words, "x": xs})
    item = subject._queue.get()
    assert isinstance(item, py._Batch)
    return item, src._make_batch_delta(item)


def test_python_connector_ships_batches_as_frames():
    frames, _ = _mods("pathway_tpu_torch")
    rng = np.random.default_rng(12)
    words = [f"w{int(i)}" for i in rng.integers(0, 40, 500)]
    xs = [int(v) for v in rng.integers(-1000, 1000, 500)]
    item, d = _python_batch("pathway_tpu_torch", words, xs)
    assert item.frame is not None, "the producer did not wrap the batch"
    assert frames.open_connector_frame(item.frame).data is item.data
    assert d.data is item.data, "the engine-side open copied the producer's buffers"
    assert d.keys_content_cols == ("word", "x")
    _, want = _python_batch("pathway_tpu", words, xs)
    _assert_delta_equal(d, want)
