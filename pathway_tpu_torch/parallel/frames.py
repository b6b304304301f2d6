"""Zero-copy columnar wire protocol for the cluster data plane.

The reference moves exchange records between processes as raw byte
buffers through timely's ``zero_copy`` allocator
(``external/timely-dataflow/communication/src/allocator/zero_copy/``:
``bytes_exchange.rs`` hands pre-serialized regions straight to the
socket). This module is that wire format for ClusterComm's Delta
frames: a compact binary frame whose dense numpy columns are appended
**verbatim** — ``memoryview`` on encode, ``np.frombuffer`` on decode —
so a cross-process exchange never pickles a numeric column and never
copies it on receive. Object/string columns fall back to a
length-prefixed pickle section inside the same frame, so semantics are
unchanged for arbitrary python values.

Frame layout (all integers big-endian, following the 8-byte length
prefix the socket loop already speaks)::

    u8  kind      KIND_COLUMNAR (pickled control frames use KIND_PICKLE)
    u8  version
    q   tick      logical time of the exchange
    I   src       sending worker id
    I   n_dsts    destination sections that follow
    I   meta_len  + pickle((channel, trace_ctx))   # edge id + (run_id, flow_id)
    per destination:
        I   dst   destination worker id
        u8  ptype PT_PICKLE | PT_DELTA | PT_COLS
        payload

A ``PT_DELTA`` payload is ``I n_rows, H n_cols`` followed by a column
directory (name, encoding, dtype, nbytes per column — keys and diffs
are the two unnamed leading entries) and then the column buffers in
directory order. Raw buffers are padded so each starts 8-byte aligned
relative to the frame body, letting the decoder ``frombuffer`` the recv
buffer in place; both sides derive the padding from the same running
offset, so it is never transmitted. ``PT_COLS`` reuses the identical
column codec for the mesh host-boundary frames (``(src, {name: col})``
object-column swaps of MultiHostMeshComm); ``PT_PICKLE`` carries any
other payload shape unchanged.

A decoder that reads past the buffer, or a directory whose lengths
disagree with the frame, raises :class:`CorruptFrame` — the reader
thread turns that into a named ``_broken`` mark instead of feeding
garbage arrays into operator state.

Copy of ``pathway_tpu/parallel/frames.py``: the codec of the cluster's frames
(``parallel/cluster.py``) and of the connector seam (``connector_frame``, by
reference in process).
"""

from __future__ import annotations

import pickle
import struct
from typing import Any

import numpy as np

__all__ = [
    "KIND_PICKLE",
    "KIND_COLUMNAR",
    "CorruptFrame",
    "encode_frame",
    "decode_frame",
    "encode_control",
    "decodable_payload",
    "connector_frame",
    "open_connector_frame",
]

KIND_PICKLE = 0  #: body[0] of a pickled control frame (allgather/ping/bye)
KIND_COLUMNAR = 1  #: body[0] of a binary columnar exchange frame
_VERSION = 1

PT_PICKLE = 0  #: payload: arbitrary pickled object
PT_DELTA = 1  #: payload: an engine Delta (keys/diffs + named columns)
PT_COLS = 2  #: payload: (src:int, {name: ndarray}) — mesh host columns

_FRAME = struct.Struct(">BBqIII")  # kind, version, tick, src, n_dsts, meta_len
_SECTION = struct.Struct(">IB")  # dst, ptype
_COLS_HDR = struct.Struct(">IH")  # n_rows, n_cols
_COL_RAW = struct.Struct(">B")  # encoding tag
_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_ALIGN = 8

#: numpy dtype kinds shipped as raw buffers (fixed-width, no object refs);
#: everything else (object, str, void) rides the pickle section
_RAW_KINDS = frozenset("iufbMm")

#: column-count sanity bound, shared by encoder (fall back to pickle)
#: and decoder (reject as corrupt) so a legitimately wide payload can
#: never be refused on arrival
_MAX_COLS = 4096

_ENC_RAW = 0
_ENC_PICKLE = 1


class CorruptFrame(ValueError):
    """A wire frame failed structural validation — truncated, torn or
    corrupted in flight. The reader thread flips ``_broken`` with this
    as the named origin rather than deserializing garbage."""


class _Writer:
    """Accumulates bytes-like chunks while tracking the running frame
    offset (the alignment authority both ends share)."""

    __slots__ = ("chunks", "offset")

    def __init__(self) -> None:
        self.chunks: list[Any] = []
        self.offset = 0

    def put(self, b: Any) -> None:
        n = len(b)
        if n:
            self.chunks.append(b)
            self.offset += n

    def align(self) -> None:
        pad = -self.offset % _ALIGN
        if pad:
            self.put(b"\x00" * pad)


def _put_columns(w: _Writer, entries: list[tuple[str, np.ndarray]], n_rows: int) -> None:
    """Directory + buffers for one column set. ``entries`` order is the
    decode order; every column must hold exactly ``n_rows`` values."""
    w.put(_COLS_HDR.pack(n_rows, len(entries)))
    dirbuf = bytearray()
    bufs: list[tuple[int, Any]] = []
    for name, arr in entries:
        arr = np.asarray(arr)
        nm = name.encode("utf-8")
        dirbuf += struct.pack(">H", len(nm)) + nm
        if arr.ndim == 1 and arr.dtype.kind in _RAW_KINDS and not arr.dtype.hasobject:
            if not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr)
            ds = arr.dtype.str.encode("ascii")
            dirbuf += _COL_RAW.pack(_ENC_RAW)
            dirbuf += struct.pack(">B", len(ds)) + ds
            dirbuf += struct.pack(">Q", arr.nbytes)
            # datetime64/timedelta64 refuse the buffer protocol — export
            # their bytes through an int64 view; the directory keeps the
            # real dtype, which frombuffer accepts on decode
            raw = arr.view(np.int64) if arr.dtype.kind in "Mm" else arr
            bufs.append((_ENC_RAW, memoryview(raw).cast("B")))
        else:
            blob = pickle.dumps(arr, protocol=pickle.HIGHEST_PROTOCOL)
            dirbuf += _COL_RAW.pack(_ENC_PICKLE)
            dirbuf += struct.pack(">B", 0)
            dirbuf += struct.pack(">Q", len(blob))
            bufs.append((_ENC_PICKLE, blob))
    w.put(bytes(dirbuf))
    for enc, data in bufs:
        if enc == _ENC_RAW:
            w.align()
        w.put(data)


def _payload_entries(payload: Any) -> tuple[int, list, int] | None:
    """Classify a payload for the columnar codec: returns
    (ptype, entries, n_rows) or None for the pickle fallback."""
    from ..engine.delta import Delta

    if isinstance(payload, Delta):
        entries = [("\x00k", payload.keys), ("\x00d", payload.diffs)]
        entries += list(payload.data.items())
        # mirror the decoder's column-count sanity bound: a wider-than-
        # plausible set ships via the pickle fallback instead of being
        # refused as corrupt on arrival
        if len(entries) > _MAX_COLS:
            return None
        return PT_DELTA, entries, len(payload)
    if (
        isinstance(payload, tuple)
        and len(payload) == 2
        and isinstance(payload[0], (int, np.integer))
        and isinstance(payload[1], dict)
        and payload[1]
        and len(payload[1]) <= _MAX_COLS
        and all(isinstance(v, np.ndarray) for v in payload[1].values())
    ):
        cols = payload[1]
        lens = {len(v) for v in cols.values()}
        if len(lens) == 1:
            return PT_COLS, list(cols.items()), lens.pop()
    return None


def encode_frame(
    channel: Any,
    tick: int,
    src: int,
    per_dst: dict[int, Any],
    ctx: tuple | None = None,
) -> tuple[list[Any], int]:
    """Encode one exchange frame → (chunks, total_bytes). Chunks are
    bytes-like (dense columns are live memoryviews of the sender's
    arrays — callers must treat them as immutable until sent, which the
    engine's column-immutability convention already guarantees)."""
    meta = pickle.dumps((channel, ctx), protocol=pickle.HIGHEST_PROTOCOL)
    w = _Writer()
    w.put(_FRAME.pack(KIND_COLUMNAR, _VERSION, tick, src, len(per_dst), len(meta)))
    w.put(meta)
    for dst, payload in per_dst.items():
        cls = _payload_entries(payload)
        if cls is None:
            blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
            w.put(_SECTION.pack(dst, PT_PICKLE))
            # u64 length: the fallback must carry anything the old all-
            # pickled plane could (a >4 GiB object graph included)
            w.put(_U64.pack(len(blob)))
            w.put(blob)
            continue
        ptype, entries, n_rows = cls
        w.put(_SECTION.pack(dst, ptype))
        if ptype == PT_COLS:
            w.put(_U32.pack(int(payload[0])))
        _put_columns(w, entries, n_rows)
    return w.chunks, w.offset


def encode_control(frame: tuple) -> bytes:
    """Pickle a control frame (allgather/barrier payloads, ping/pong,
    bye) behind the KIND_PICKLE tag byte."""
    return bytes([KIND_PICKLE]) + pickle.dumps(
        frame, protocol=pickle.HIGHEST_PROTOCOL
    )


class _Reader:
    __slots__ = ("buf", "mv", "offset")

    def __init__(self, buf: Any) -> None:
        self.buf = buf
        self.mv = memoryview(buf)
        self.offset = 0

    def take(self, n: int) -> memoryview:
        end = self.offset + n
        if n < 0 or end > len(self.mv):
            raise CorruptFrame(
                f"frame truncated: need {n} bytes at offset {self.offset}, "
                f"have {len(self.mv)}"
            )
        out = self.mv[self.offset : end]
        self.offset = end
        return out

    def unpack(self, st: struct.Struct) -> tuple:
        return st.unpack(self.take(st.size))

    def align(self) -> None:
        pad = -self.offset % _ALIGN
        if pad:
            self.take(pad)


def _read_columns(r: _Reader) -> tuple[int, list[tuple[str, np.ndarray]]]:
    n_rows, n_cols = r.unpack(_COLS_HDR)
    if n_rows > (1 << 40) or n_cols > _MAX_COLS:
        raise CorruptFrame(f"implausible column set ({n_rows} rows x {n_cols} cols)")
    directory = []
    for _ in range(n_cols):
        (nlen,) = r.unpack(_U16)
        name = bytes(r.take(nlen)).decode("utf-8")
        (enc,) = r.unpack(_COL_RAW)
        (dlen,) = r.unpack(_U8)
        dstr = bytes(r.take(dlen)).decode("ascii")
        (nbytes,) = r.unpack(_U64)
        directory.append((name, enc, dstr, nbytes))
    out: list[tuple[str, np.ndarray]] = []
    for name, enc, dstr, nbytes in directory:
        if enc == _ENC_RAW:
            try:
                dtype = np.dtype(dstr)
            except TypeError as e:
                raise CorruptFrame(f"column {name!r}: bad dtype {dstr!r}") from e
            if dtype.itemsize == 0 or nbytes % dtype.itemsize:
                raise CorruptFrame(
                    f"column {name!r}: {nbytes} bytes is not a multiple of "
                    f"dtype {dstr!r} ({dtype.itemsize}B items)"
                )
            if nbytes // dtype.itemsize != n_rows:
                raise CorruptFrame(
                    f"column {name!r}: {nbytes // dtype.itemsize} values for "
                    f"{n_rows} rows"
                )
            r.align()
            # zero-copy: the array aliases the recv buffer (a bytearray,
            # so the result is an ordinary writable array)
            arr = np.frombuffer(r.take(nbytes), dtype=dtype)
        elif enc == _ENC_PICKLE:
            try:
                arr = pickle.loads(r.take(nbytes))
            except Exception as e:
                raise CorruptFrame(f"column {name!r}: bad pickle section ({e})") from e
            if not isinstance(arr, np.ndarray) or len(arr) != n_rows:
                raise CorruptFrame(
                    f"column {name!r}: pickle section is not a {n_rows}-row column"
                )
        else:
            raise CorruptFrame(f"column {name!r}: unknown encoding {enc}")
        out.append((name, arr))
    return n_rows, out


def decode_frame(buf: Any) -> tuple:
    """Decode one columnar frame body → ``("x", channel, tick, src,
    per_dst, ctx)`` — the same tuple shape the pickled protocol used, so
    inbox delivery is codec-agnostic. Dense columns alias ``buf``."""
    from ..engine.delta import Delta

    r = _Reader(buf)
    kind, version, tick, src, n_dsts, meta_len = r.unpack(_FRAME)
    if kind != KIND_COLUMNAR or version != _VERSION:
        raise CorruptFrame(f"bad frame tag (kind={kind}, version={version})")
    if n_dsts > 1 << 20:
        raise CorruptFrame(f"implausible destination count {n_dsts}")
    try:
        channel, ctx = pickle.loads(r.take(meta_len))
    except CorruptFrame:
        raise
    except Exception as e:
        raise CorruptFrame(f"bad frame metadata ({e})") from e
    per_dst: dict[int, Any] = {}
    for _ in range(n_dsts):
        dst, ptype = r.unpack(_SECTION)
        if ptype == PT_PICKLE:
            (blen,) = r.unpack(_U64)
            try:
                per_dst[dst] = pickle.loads(r.take(blen))
            except CorruptFrame:
                raise
            except Exception as e:
                raise CorruptFrame(f"dst {dst}: bad pickled payload ({e})") from e
            continue
        if ptype == PT_COLS:
            (src_tag,) = r.unpack(_U32)
            _n_rows, cols = _read_columns(r)
            per_dst[dst] = (src_tag, dict(cols))
            continue
        if ptype != PT_DELTA:
            raise CorruptFrame(f"dst {dst}: unknown payload type {ptype}")
        _n_rows, cols = _read_columns(r)
        if len(cols) < 2 or cols[0][0] != "\x00k" or cols[1][0] != "\x00d":
            raise CorruptFrame(f"dst {dst}: delta payload missing key/diff columns")
        keys = cols[0][1]
        diffs = cols[1][1]
        if keys.dtype != np.uint64 or diffs.dtype != np.int64:
            raise CorruptFrame(
                f"dst {dst}: key/diff dtypes {keys.dtype}/{diffs.dtype}"
            )
        per_dst[dst] = Delta(
            keys=keys, data=dict(cols[2:]), diffs=diffs
        )
    if r.offset != len(r.mv):
        raise CorruptFrame(
            f"{len(r.mv) - r.offset} trailing bytes after the last section"
        )
    return ("x", channel, tick, src, per_dst, ctx)


def decodable_payload(payload: Any) -> bool:
    """True when the codec will ship this payload columnar (tests +
    LocalComm's no-serialization assertion use this to know which
    payloads the binary path covers)."""
    return _payload_entries(payload) is not None


#: channel id of in-process connector-batch frames — the ingest→engine
#: seam (a real exchange channel id is a non-negative edge id)
INGEST_CHANNEL = -1


def connector_frame(delta: Any, tick: int = -1, src: int = 0) -> tuple:
    """Wrap one ingest Delta as a wire frame: a connector batch IS an
    exchange frame, so handing it to the engine is the same operation as
    handing it to a remote worker. In process the tuple carries the Delta
    **by reference** (LocalComm.exchange's contract — never serialize on
    a local hop); across processes ``encode_frame`` ships the identical
    shape binary. Asserting decodability here means a columnar reader
    can never build a batch the cluster data plane would refuse."""
    assert decodable_payload(delta), (
        "connector batch must be frame-codec decodable"
    )
    return ("x", INGEST_CHANNEL, tick, src, {src: delta}, None)


def open_connector_frame(frame: Any) -> Any:
    """Unwrap a connector-batch frame back to its Delta. An in-process
    tuple returns the referenced Delta itself (pass-by-reference: callers
    assert identity, like LocalComm.exchange); an encoded byte frame is
    decoded through the columnar codec."""
    if isinstance(frame, (bytes, bytearray, memoryview)):
        _kind, _channel, _tick, src, per_dst, _ctx = decode_frame(frame)
        return per_dst[src]
    _kind, _channel, _tick, src, per_dst, _ctx = frame
    return per_dst[src]
