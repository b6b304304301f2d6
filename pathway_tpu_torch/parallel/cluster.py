"""TCP cluster communication for multi-process workers.

The ``zero_copy`` allocator analog (``external/timely-dataflow/communication/
src/allocator/zero_copy/``): processes form a full mesh of sockets
(process p listens at its address-book entry — default ``first_port + p``
on one machine, or one ``host[:port]`` per process via ``PATHWAY_ADDRESSES``
for multi-host/DCN clusters, the timely hostfile analog
(``communication/src/initialize.rs``); higher pids dial lower ones).

Data plane (``parallel/frames.py``): exchange frames are the **zero-copy
columnar wire protocol** — one binary frame per (exchange, remote
process) carries all buckets for that process's workers, dense numpy
columns appended verbatim (memoryview on encode, ``frombuffer`` on
decode) and object columns in a pickle section. Sends are **pipelined**:
``exchange`` encodes and enqueues onto a per-peer writer thread (bounded
by ``PATHWAY_COMM_QUEUE_FRAMES``) and returns to the tick loop instead
of blocking on ``sendall``; every frame queued for the same peer when
its writer wakes is coalesced into one vectored ``sendmsg`` batch — the
timely ``send_loop``/``BytesExchange`` split (zero_copy/tcp.rs). Writer
death flips ``_broken`` exactly like reader death, so the fast
failure-propagation contract is unchanged. Control frames (allgather,
ping/pong, bye) stay pickled behind a tag byte.

``python -m pathway_tpu_torch.cli spawn -n M -t T program.py`` launches M
processes, each hosting T worker threads; every process runs the identical
dataflow build and owns the key shards of its workers
(internals/graph_runner._run_sharded).

Copy of ``pathway_tpu/parallel/cluster.py`` (``ClusterComm`` with its
writers, clock offsets, fast failure, async plane and serve plane;
``_address_book``, ``_parse_address``) without the ``comm.send`` chaos site:
the port has no fault plans (``chaos/``), so every frame goes straight to its
peer's writer. The serve plane is copied as it is and waits for sharded
serving, which no caller of the port wires yet.
"""

from __future__ import annotations

import collections
import pickle
import random
import socket
import struct
import threading
import time
from typing import Any

from . import frames
from .comm import Comm

__all__ = ["ClusterComm"]

_LEN = struct.Struct(">Q")
#: defaults; per-instance values come from PATHWAY_CONNECT_TIMEOUT_S /
#: PATHWAY_COLLECTIVE_TIMEOUT_S (internals/config.py) so deployments can
#: tune how long a worker waits before declaring its peers gone
CONNECT_TIMEOUT_S = 30.0
COLLECTIVE_TIMEOUT_S = 600.0
#: default bound of each per-peer writer queue (frames); the knob is
#: PATHWAY_COMM_QUEUE_FRAMES — a full queue blocks the enqueuing worker,
#: which is the backpressure that keeps a slow peer from buffering the
#: whole stream in sender memory
QUEUE_FRAMES = 256
#: a length prefix past this is a torn/corrupt stream, not a real frame
#: (1 TiB — far above any exchange batch, far below a garbage u64)
_MAX_FRAME_BYTES = 1 << 40
#: sendmsg scatter-gather width per syscall (IOV_MAX is 1024 on linux;
#: stay under it with margin)
_IOV_MAX = 512


#: frames under this size are joined into one contiguous wire buffer and
#: written with a single send; above it, scatter-gather sendmsg avoids
#: the memcpy. Measured on this class of host a sendmsg syscall costs
#: ~300 us regardless of size while the join copies at ~10 GB/s, so the
#: crossover sits in the megabytes
_JOIN_MAX_BYTES = 4 << 20


def _send_vectored(sock: socket.socket, chunks: list) -> None:
    """sendall for a list of bytes-like chunks. Small/medium frames are
    coalesced into ONE contiguous buffer and one ``sendall`` (a single
    memcpy beats per-iovec syscall overhead by orders of magnitude at
    these sizes); only multi-megabyte batches take the zero-copy
    ``sendmsg`` scatter-gather path, chunked to ≤ _IOV_MAX iovecs with
    partial-send resume."""
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is None or sum(len(c) for c in chunks) <= _JOIN_MAX_BYTES:
        sock.sendall(b"".join(chunks))
        return
    i = 0
    n = len(chunks)
    while i < n:
        try:
            sent = sendmsg(chunks[i : i + _IOV_MAX])
        except InterruptedError:  # pragma: no cover
            continue
        while sent:
            c = chunks[i]
            if sent >= len(c):
                sent -= len(c)
                i += 1
            else:
                # partial chunk: resume from a suffix view
                chunks[i] = memoryview(c)[sent:]
                sent = 0


class _PeerWriter:
    """One outbound pipeline: a bounded frame queue drained by a
    dedicated thread. ``send`` is opportunistic — a frame headed to an
    IDLE pipeline is written inline by the calling thread (in the
    bulk-synchronous exchange the sender blocks on peer frames right
    after sending, so there is nothing to overlap and the thread
    handoff would be pure latency), while any frame arriving behind
    other traffic — another worker mid-send on this link, or a backlog
    a slow peer left queued — rides the writer thread. The drain loop
    batches every queued frame into a single vectored send, which is
    where per-tick frames headed to the same peer coalesce into one
    syscall batch. An ``_io_lock`` serializes inline and drain-loop
    writes, and the FIFO rule is "inline only when nothing is queued or
    in flight", so per-thread frame order is preserved."""

    def __init__(self, comm: "ClusterComm", peer: int, sock: socket.socket,
                 max_frames: int):
        self._comm = comm
        self.peer = peer
        self._sock = sock
        self._max = max(1, max_frames)
        self._q: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._io_lock = threading.Lock()
        self._closed = False
        # per-writer counters (mutated only under _io_lock; summed by
        # comm_stats into the pathway_comm_* gauges)
        self.bytes_sent = 0
        self.frames_sent = 0
        self.frames_coalesced = 0
        self.thread = threading.Thread(
            target=self._run, name=f"pw-comm-writer-p{peer}", daemon=True
        )
        self.thread.start()

    def queue_depth(self) -> int:
        return len(self._q)

    def send(self, chunks: list, nbytes: int) -> None:
        if (
            not self._q
            and not self._closed
            and self._comm._broken is None
            and self._io_lock.acquire(blocking=False)
        ):
            # inline fast path: the pipeline is idle, so ordering is
            # trivially preserved and the thread handoff is skipped
            try:
                _send_vectored(self._sock, list(chunks))
                self.bytes_sent += nbytes
                self.frames_sent += 1
            except OSError as e:
                if not self._comm._closing:
                    self._comm._break(
                        f"send to process {self.peer} failed ({e})"
                    )
                raise RuntimeError(
                    self._comm._broken or "cluster send failed"
                ) from None
            finally:
                self._io_lock.release()
            return
        self.enqueue(chunks, nbytes)

    def enqueue(self, chunks: list, nbytes: int) -> None:
        with self._cond:
            while (
                len(self._q) >= self._max
                and not self._closed
                and self._comm._broken is None
            ):
                self._cond.wait(timeout=0.1)
            if self._closed or self._comm._broken is not None:
                raise RuntimeError(
                    self._comm._broken
                    or f"cluster send to process {self.peer} after close"
                )
            self._q.append((chunks, nbytes))
            self._cond.notify_all()

    def close(self) -> None:
        """Stop accepting frames; the drain loop exits after flushing
        everything already queued."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def join(self, timeout: float) -> None:
        self.thread.join(timeout)

    def _run(self) -> None:
        # the same must-not-die-mute contract as the reader threads: ANY
        # failure here would otherwise strand enqueuers (queue full, no
        # drain) and peers (frames never sent) until the collective
        # timeout, with no recorded cause
        try:
            self._drain_loop()
        except BaseException as e:  # noqa: BLE001
            if not self._comm._closing:
                self._comm._break(
                    f"writer thread for process {self.peer} failed: {e!r}"
                )

    def _drain_loop(self) -> None:
        comm = self._comm
        while True:
            with self._cond:
                while not self._q and not self._closed:
                    self._cond.wait()
                closed = self._closed
            # take the io lock BEFORE popping: "queue empty AND io lock
            # free" (the inline-send gate) then implies no popped-but-
            # unsent frame exists anywhere — the FIFO invariant
            with self._io_lock:
                with self._cond:
                    batch = list(self._q)
                    self._q.clear()
                    self._cond.notify_all()  # room freed: wake enqueuers
                if batch:
                    flat: list = []
                    nbytes = 0
                    for chunks, fb in batch:
                        flat.extend(chunks)
                        nbytes += fb
                    try:
                        _send_vectored(self._sock, flat)
                    except OSError as e:
                        if not comm._closing:
                            comm._break(
                                f"send to process {self.peer} failed ({e}) "
                                "(writer thread)"
                            )
                        return
                    self.bytes_sent += nbytes
                    self.frames_sent += len(batch)
                    if len(batch) > 1:
                        self.frames_coalesced += len(batch) - 1
            if closed and not self._q:
                return


class ClusterComm(Comm):
    def __init__(
        self,
        process_id: int,
        n_processes: int,
        threads_per_process: int,
        first_port: int,
        host: str = "127.0.0.1",
        addresses: list[str] | None = None,
        connect_timeout_s: float | None = None,
        collective_timeout_s: float | None = None,
    ):
        from ..internals.config import _env_float

        self.connect_timeout_s = (
            connect_timeout_s
            if connect_timeout_s is not None
            else _env_float("PATHWAY_CONNECT_TIMEOUT_S", CONNECT_TIMEOUT_S)
        )
        self.collective_timeout_s = (
            collective_timeout_s
            if collective_timeout_s is not None
            else _env_float(
                "PATHWAY_COLLECTIVE_TIMEOUT_S", COLLECTIVE_TIMEOUT_S
            )
        )
        self.process_id = process_id
        self.n_processes = n_processes
        self.threads = threads_per_process
        self.n_workers = n_processes * threads_per_process
        #: per-process (host, port) book — the timely hostfile analog
        #: (communication/src/initialize.rs); default: one machine, ports
        #: first_port..first_port+n-1
        self._addrs = _address_book(addresses, n_processes, host, first_port)
        self._local_workers = set(
            process_id * threads_per_process + i
            for i in range(threads_per_process)
        )
        self._cond = threading.Condition()
        self._barrier_seqs: dict[int, int] = {}
        #: ("x", channel, tick, dst) -> {src: payload}
        #: ("g", tag) -> {src: payload}
        self._inbox: dict[Any, dict[int, Any]] = {}
        self._gather_reads: dict[Any, int] = {}
        #: async (frontier-driven) plane: per-LOCAL-worker event inboxes.
        #: Remote arrivals ride the same columnar frames as BSP exchange
        #: (meta channel tagged ("a", ...)) and are filed here by the
        #: reader threads instead of the rendezvous inbox.
        self._async_q: dict[int, collections.deque] = {
            w: collections.deque() for w in self._local_workers
        }
        self._async_data: dict[int, int] = {w: 0 for w in self._local_workers}
        self._async_wakers: dict[int, Any] = {}
        from .comm import async_queue_bound, serve_queue_bound

        self._async_bound = async_queue_bound()
        #: serve plane (pathway_tpu/serve/): per-LOCAL-worker query
        #: event inboxes, bounded and drop-on-overflow — a lost serve
        #: event degrades one gather, never wedges the dataflow
        self._serve_q: dict[int, collections.deque] = {
            w: collections.deque() for w in self._local_workers
        }
        self._serve_bound = serve_queue_bound()
        self._serve_dropped = 0
        self._broken: str | None = None
        self._socks: dict[int, socket.socket] = {}
        self._writers: dict[int, _PeerWriter] = {}
        self._readers: list[threading.Thread] = []
        self._listener: socket.socket | None = None
        self._closing = False
        from ..internals.config import _env_int

        self._queue_frames = _env_int("PATHWAY_COMM_QUEUE_FRAMES", QUEUE_FRAMES)
        # observability counters (GIL-cheap, read by comm_stats; send-side
        # counters live on the per-peer writers — single-writer, race-free)
        self.bytes_received = 0
        self.frames_received = 0
        self.encode_ns = 0
        self._encode_lock = threading.Lock()
        # tracing site: frames carry a (run_id, flow_id) context so both
        # ends of every cross-process frame emit linked flow events
        from ..internals.tracing import get_tracer, mint_flow_tag

        self._tracer = get_tracer()
        import itertools as _itertools

        self._flow_seq = _itertools.count()
        self._flow_tag = mint_flow_tag()
        #: peer process id -> (unix-clock offset ns, rtt ns), offset = peer
        #: clock minus ours; min-rtt sample of the handshake ping burst
        self.clock_offsets: dict[int, tuple[float, float]] = {}
        self._pongs_seen: dict[int, int] = {}
        self._connect_mesh()
        # only a tracer consumes the offsets — an untraced run must not pay
        # the ping burst (or its cond-wait) at every mesh establishment
        if self.n_processes > 1 and self._tracer is not None:
            self._measure_clock_offsets()
            self._tracer.set_clock_offsets(self.clock_offsets)

    # -- mesh setup ------------------------------------------------------

    def _connect_mesh(self) -> None:
        if self.n_processes == 1:
            return
        my_port = self._addrs[self.process_id][1]
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # bind all interfaces: with an address book, peers dial in over DCN
        # from other machines; the book entry is how THEY reach us
        self._listener.bind(("" if len({h for h, _ in self._addrs}) > 1
                             else self._addrs[self.process_id][0], my_port))
        self._listener.listen(self.n_processes)

        expected_inbound = self.n_processes - 1 - self.process_id

        def accept_loop() -> None:
            for _ in range(expected_inbound):
                conn, _addr = self._listener.accept()
                peer = _LEN.unpack(_recv_exact(conn, 8))[0]
                self._register_peer(int(peer), conn)

        acceptor = threading.Thread(target=accept_loop, daemon=True)
        acceptor.start()

        # dial every lower pid (they accept from us); unreachable peers are
        # retried with jittered exponential backoff until the connect
        # timeout — a restarting peer (supervised ensemble, rolling deploy)
        # needs a window to come back without synchronized reconnect storms
        for peer in range(self.process_id):
            peer_host, peer_port = self._addrs[peer]
            deadline = time.monotonic() + self.connect_timeout_s
            delay, last_err = 0.05, None
            while True:
                try:
                    s = socket.create_connection(
                        (peer_host, peer_port), timeout=2.0
                    )
                    break
                except OSError as e:
                    last_err = e
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"process {self.process_id}: peer process {peer} "
                            f"not reachable on {peer_host}:{peer_port} after "
                            f"{self.connect_timeout_s:.0f}s ({last_err})"
                        ) from e
                    time.sleep(delay * (0.5 + random.random()))
                    delay = min(delay * 2, 1.0)
            s.sendall(_LEN.pack(self.process_id))
            self._register_peer(peer, s)
        acceptor.join(self.connect_timeout_s)
        if len(self._socks) != self.n_processes - 1:
            missing = sorted(
                set(range(self.n_processes))
                - set(self._socks)
                - {self.process_id}
            )
            raise RuntimeError(
                f"process {self.process_id}: cluster mesh incomplete "
                f"({len(self._socks)}/{self.n_processes - 1} peers; "
                f"missing processes {missing})"
            )

    def _register_peer(self, peer: int, sock: socket.socket) -> None:
        # dialed sockets inherit create_connection's 2s timeout; the mesh
        # must tolerate arbitrarily long quiet periods (idle sources, slow
        # peers) — make every registered socket blocking
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._socks[peer] = sock
        self._writers[peer] = _PeerWriter(self, peer, sock, self._queue_frames)
        t = threading.Thread(target=self._read_loop, args=(peer, sock), daemon=True)
        t.start()
        self._readers.append(t)

    def _read_loop(self, peer: int, sock: socket.socket) -> None:
        try:
            while True:
                header = _recv_exact(sock, 8)
                n_body = _LEN.unpack(header)[0]
                if not 0 < n_body <= _MAX_FRAME_BYTES:
                    raise frames.CorruptFrame(
                        f"frame length {n_body} outside sanity bounds"
                    )
                body = _recv_into(sock, n_body)
                self.bytes_received += 8 + n_body
                self.frames_received += 1
                if body[0] == frames.KIND_COLUMNAR:
                    # zero-copy decode: dense columns alias `body`
                    frame = frames.decode_frame(body)
                else:
                    try:
                        frame = pickle.loads(memoryview(body)[1:])
                    except Exception as e:
                        raise frames.CorruptFrame(
                            f"bad control frame ({e})"
                        ) from e
                kind = frame[0]
                if kind == "bye":
                    # graceful: the peer finished its dataflow (all its
                    # collectives, incl. the END_TIME sweep, completed) and
                    # is shutting down — everything it owed us was already
                    # delivered in order before this frame
                    return
                if kind == "ping":
                    # clock-sync probe: echo (seq, t0) back with our recv
                    # time, straight from the reader thread so the sample
                    # measures the wire, not a collective's queueing
                    self._send(
                        peer, ("pong", frame[1], frame[2], time.time_ns())
                    )
                    continue
                if kind == "pong":
                    self._note_pong(
                        peer, frame[2], frame[3], time.time_ns()
                    )
                    continue
                tracer = self._tracer
                t0 = time.perf_counter_ns() if tracer is not None else 0
                ctx = self._deliver(frame)
                if tracer is not None and ctx is not None:
                    # f before complete: the flow's binding point must fall
                    # inside the comm.recv slice on this reader thread
                    tracer.flow_end("comm.frame", ctx[1], from_process=peer)
                    tracer.complete(
                        "comm.recv",
                        t0,
                        {"from_process": peer, "bytes": 8 + n_body},
                    )
        except frames.CorruptFrame as e:
            # torn/corrupted wire bytes: refuse to deserialize garbage —
            # name the origin and fail the process's collectives fast
            if not self._closing:
                self._break(
                    f"corrupt frame from process {peer}: {e} "
                    "(reader thread refused to deserialize)"
                )
        except (OSError, EOFError) as e:
            # peer socket death: the fast-propagation path — flip _broken
            # and wake every blocked collective NOW, not at the timeout
            if not self._closing:
                self._break(
                    f"connection to process {peer} lost ({e or 'EOF'})"
                )
        except BaseException as e:  # noqa: BLE001 — reader must not die mute
            # ANY reader-thread failure (bad pickle, memory pressure, a bug)
            # would otherwise strand this process's workers in collectives
            # until the timeout with no record of why
            if not self._closing:
                self._break(f"reader thread for process {peer} failed: {e!r}")

    def _deliver(self, frame: tuple) -> tuple | None:
        """File a data/control frame into the inbox; returns the frame's
        trace context (run_id, flow_id) when the sender shipped one."""
        kind = frame[0]
        ctx = None
        wake: list[int] = []
        with self._cond:
            if kind == "x":
                _, channel, tick, src, per_dst = frame[:5]
                ctx = frame[5] if len(frame) > 5 else None
                if isinstance(channel, tuple) and channel and channel[0] == "a":
                    # async data plane: file per-worker events, never the
                    # rendezvous inbox (nothing is waiting collectively).
                    # The reader thread NEVER blocks on the inbox bound —
                    # remote backpressure is the peer-status depth the
                    # executor consults before polling sources.
                    _a, real_channel, ingest_ns, seq = channel[:4]
                    enq_ns = channel[4] if len(channel) > 4 else None
                    for dst, payload in per_dst.items():
                        q = self._async_q.get(dst)
                        if q is None:
                            continue  # stale frame for a non-local worker
                        q.append(
                            ("x", real_channel, tick, src, payload,
                             ingest_ns, seq, enq_ns)
                        )
                        self._async_data[dst] += 1
                        wake.append(dst)
                elif (
                    isinstance(channel, tuple)
                    and channel
                    and channel[0] == "s"
                ):
                    # serve plane: (meta, payload) query events into the
                    # bounded serve inboxes — overflow DROPS (counted);
                    # the origin's partial-gather timeout is the recovery
                    meta = channel[1]
                    for dst, payload in per_dst.items():
                        q = self._serve_q.get(dst)
                        if q is None:
                            continue  # stale frame for a non-local worker
                        if len(q) >= self._serve_bound:
                            self._serve_dropped += 1
                            continue
                        q.append((meta, payload))
                else:
                    for dst, payload in per_dst.items():
                        self._inbox.setdefault(("x", channel, tick, dst), {})[src] = payload
            elif kind == "ac":
                # async control broadcast: fan out to every local worker
                _, src, payload = frame[:3]
                ctx = frame[3] if len(frame) > 3 else None
                for dst, q in self._async_q.items():
                    q.append(("c", src, payload))
                    wake.append(dst)
            else:
                _, tag, src, obj = frame[:4]
                ctx = frame[4] if len(frame) > 4 else None
                self._inbox.setdefault(("g", tag), {})[src] = obj
            self._cond.notify_all()
        for dst in wake:
            waker = self._async_wakers.get(dst)
            if waker is not None:
                waker.set()
        return ctx

    # -- clock-offset estimation (mesh establishment) --------------------

    def _note_pong(self, peer: int, t0_ns: int, t1_ns: int, t2_ns: int) -> None:
        """One ping round trip: we sent at ``t0``, the peer stamped ``t1``
        on receipt, the pong landed here at ``t2``. NTP-style estimate:
        offset = t1 - (t0+t2)/2 (peer clock minus ours), error bounded by
        rtt/2 — the min-rtt sample of the burst wins."""
        rtt = t2_ns - t0_ns
        offset = t1_ns - (t0_ns + t2_ns) / 2
        with self._cond:
            best = self.clock_offsets.get(peer)
            if best is None or rtt < best[1]:
                self.clock_offsets[peer] = (float(offset), float(rtt))
            self._pongs_seen[peer] = self._pongs_seen.get(peer, 0) + 1
            self._cond.notify_all()

    def _measure_clock_offsets(
        self, n_pings: int = 4, timeout_s: float = 2.0
    ) -> None:
        """Ping every peer during mesh establishment so the per-process
        trace files can be merged onto one timeline even across hosts with
        skewed clocks (`trace merge`). Best-effort: a peer that
        never answers simply has no offset estimate (merge falls back to
        raw unix origins)."""
        peers = list(self._socks)
        for _ in range(n_pings):
            for peer in peers:
                try:
                    self._send(peer, ("ping", 0, time.time_ns()))
                except (RuntimeError, OSError, KeyError):
                    pass
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while (
                any(self._pongs_seen.get(p, 0) < n_pings for p in peers)
                and self._broken is None
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=min(remaining, 0.1))

    def _send(self, peer: int, frame: tuple) -> None:
        """Control-frame send (pickled behind the tag byte)."""
        body = frames.encode_control(frame)
        self._enqueue(peer, [_LEN.pack(len(body)), body], 8 + len(body))

    def _enqueue(self, peer: int, chunks: list, nbytes: int) -> None:
        """Hand one framed message (length prefix included in ``chunks``)
        to ``peer``'s writer pipeline."""
        writer = self._writers.get(peer)
        if writer is None:
            raise RuntimeError(
                self._broken or f"no connection to process {peer}"
            )
        writer.send(chunks, nbytes)

    def _process_of(self, worker: int) -> int:
        return worker // self.threads

    # -- collectives -----------------------------------------------------

    def _frame_ctx(self, peer: int, **args: Any) -> tuple | None:
        """Mint a per-frame trace context (run_id, flow_id) and emit the
        sending half of the flow; None when tracing is off (frames stay
        one element longer either way — both ends run the same version)."""
        tracer = self._tracer
        if tracer is None:
            return None
        from ..internals.tracing import make_flow_id

        flow_id = make_flow_id(
            tracer, self._flow_tag,
            f"p{self.process_id}", next(self._flow_seq),
        )
        tracer.flow_start("comm.frame", flow_id, peer_process=peer, **args)
        return (tracer.run_id, flow_id)

    def exchange(self, channel, tick, worker_id, buckets):
        per_process: dict[int, dict[int, Any]] = {}
        with self._cond:
            for dst, payload in enumerate(buckets):
                p = self._process_of(dst)
                if p == self.process_id:
                    self._inbox.setdefault(
                        ("x", channel, tick, dst), {}
                    )[worker_id] = payload
                else:
                    per_process.setdefault(p, {})[dst] = payload
            self._cond.notify_all()
        tracer = self._tracer
        for p, per_dst in per_process.items():
            ctx = self._frame_ctx(p, channel=channel, tick=tick)
            # columnar wire codec: dense columns ride as raw buffers;
            # frames behind a backlog enqueue and return, so the tick
            # loop never blocks on a slow peer here
            t0 = time.perf_counter_ns()
            chunks, body_len = frames.encode_frame(
                channel, int(tick), worker_id, per_dst, ctx
            )
            with self._encode_lock:
                # counter shared by all worker threads: an unlocked += is
                # a lost-update race (the per-writer send counters are
                # single-owner and need none)
                self.encode_ns += time.perf_counter_ns() - t0
            if tracer is not None:
                tracer.complete(
                    "comm.encode", t0,
                    {"peer_process": p, "bytes": body_len, "channel": channel},
                )
            self._enqueue(p, [_LEN.pack(body_len)] + chunks, 8 + body_len)
        # remote processes always send a frame (even all-None buckets), so
        # completion = contributions from every worker id
        key = ("x", channel, tick, worker_id)
        payloads = self._wait(key, self.n_workers)
        with self._cond:
            self._inbox.pop(key, None)
        return [
            payloads[src]
            for src in range(self.n_workers)
            if payloads.get(src) is not None
        ]

    def allgather(self, tag, worker_id, obj):
        key = ("g", tag)
        with self._cond:
            self._inbox.setdefault(key, {})[worker_id] = obj
            self._cond.notify_all()
        # one frame per remote process, sent by each local worker for itself
        for p in range(self.n_processes):
            if p != self.process_id:
                ctx = self._frame_ctx(p, worker=worker_id)
                self._send(p, ("g", tag, worker_id, obj, ctx))
        payloads = self._wait(key, self.n_workers)
        out = [payloads[src] for src in range(self.n_workers)]
        with self._cond:
            self._gather_reads[key] = self._gather_reads.get(key, 0) + 1
            if self._gather_reads[key] >= self.threads:
                self._inbox.pop(key, None)
                self._gather_reads.pop(key, None)
        return out

    def barrier(self, worker_id: int):
        # barrier is a collective: every worker calls it the same number of
        # times, so a per-worker sequence number is a globally agreed tag
        # (a process-local counter shared by threads would diverge — the
        # threads of one process would race for tags; advisor finding r2)
        with self._cond:
            seq = self._barrier_seqs.get(worker_id, 0)
            self._barrier_seqs[worker_id] = seq + 1
        self.allgather(("b", seq), worker_id, None)

    # -- async plane (frontier-driven execution) ------------------------

    def supports_async(self) -> bool:
        return True

    def async_attach(self, worker_id: int, waker: Any) -> None:
        self._async_wakers[worker_id] = waker

    def _async_deliver_local(self, dest: int, event: tuple,
                             is_data: bool) -> None:
        # never blocks — backpressure is async_congested (see Comm)
        with self._cond:
            if self._broken is not None:
                raise RuntimeError(self._broken)
            self._async_q[dest].append(event)
            if is_data:
                self._async_data[dest] += 1
            self._cond.notify_all()
        waker = self._async_wakers.get(dest)
        if waker is not None:
            waker.set()

    def async_congested(self, worker_id: int) -> bool:
        # local thread-peers at the inbox bound, or an outbound pipeline
        # to a slow peer process at the writer-queue bound — both mean
        # "stop ingesting, let the backlog drain"
        if any(
            n >= self._async_bound
            for w, n in self._async_data.items()
            if w != worker_id
        ):
            return True
        return any(
            w.queue_depth() >= self._queue_frames
            for w in self._writers.values()
        )

    def async_post_exchange(self, worker_id, channel, time, buckets,
                            ingest_ns=None, seq=None, enq_ns=None):
        import time as time_mod  # the logical-time param shadows the module

        delivered = 0
        per_process: dict[int, dict[int, Any]] = {}
        for dst, payload in enumerate(buckets):
            if payload is None or dst == worker_id:
                continue
            p = self._process_of(dst)
            if p == self.process_id:
                self._async_deliver_local(
                    dst,
                    ("x", channel, time, worker_id, payload, ingest_ns, seq,
                     enq_ns),
                    is_data=True,
                )
                delivered += 1
            else:
                per_process.setdefault(p, {})[dst] = payload
        tracer = self._tracer
        for p, per_dst in per_process.items():
            ctx = self._frame_ctx(p, channel=channel, tick=time)
            t0 = time_mod.perf_counter_ns()
            # the async marker rides the frame metadata: same columnar
            # codec, same writer pipeline, different delivery side —
            # the enqueue stamp travels with the frame so the receiver's
            # drain can measure the enqueue->drain inbox dwell
            chunks, body_len = frames.encode_frame(
                ("a", channel, ingest_ns, seq, enq_ns), int(time), worker_id,
                per_dst, ctx,
            )
            with self._encode_lock:
                self.encode_ns += time_mod.perf_counter_ns() - t0
            if tracer is not None:
                tracer.complete(
                    "comm.encode", t0,
                    {"peer_process": p, "bytes": body_len, "channel": channel},
                )
            self._enqueue(p, [_LEN.pack(body_len)] + chunks, 8 + body_len)
            delivered += len(per_dst)
        return delivered

    def async_broadcast(self, worker_id, payload):
        for dst in self._local_workers:
            if dst != worker_id:
                self._async_deliver_local(
                    dst, ("c", worker_id, payload), is_data=False
                )
        for p in range(self.n_processes):
            if p != self.process_id:
                # rides the same _send as the BSP control plane
                self._send(p, ("ac", worker_id, payload, None))

    def async_drain(self, worker_id: int) -> list:
        with self._cond:
            if self._broken is not None:
                raise RuntimeError(
                    f"process {self.process_id}: a peer worker failed: "
                    f"{self._broken}"
                )
            q = self._async_q[worker_id]
            out = list(q)
            q.clear()
            self._async_data[worker_id] = 0
            self._cond.notify_all()
        return out

    # -- serve plane (query scatter/gather) -----------------------------

    def supports_serve(self) -> bool:
        return True

    def serve_post(self, dst_worker, meta, payload):
        import time as time_mod

        p = self._process_of(dst_worker)
        if p == self.process_id:
            with self._cond:
                if self._broken is not None:
                    return False
                q = self._serve_q.get(dst_worker)
                if q is None or len(q) >= self._serve_bound:
                    self._serve_dropped += 1
                    return False
                q.append((meta, payload))
                self._cond.notify_all()
            return True
        ctx = self._frame_ctx(p, channel="serve")
        t0 = time_mod.perf_counter_ns()
        # serve events ride the same columnar codec and the same writer
        # pipeline as exchange frames;
        # the ("s", meta) channel tag routes them into the serve inbox
        # on the receiving side instead of the rendezvous/async inboxes
        chunks, body_len = frames.encode_frame(
            ("s", meta), 0, self.process_id * self.threads,
            {dst_worker: payload}, ctx,
        )
        with self._encode_lock:
            self.encode_ns += time_mod.perf_counter_ns() - t0
        try:
            self._enqueue(p, [_LEN.pack(body_len)] + chunks, 8 + body_len)
            return True
        except (RuntimeError, OSError):
            # dead peer / torn mesh: a lost serve event degrades one
            # gather; the caller flags the shard missing
            return False

    def serve_recv(self, worker_id, timeout_s=None):
        with self._cond:
            if self._broken is not None:
                raise RuntimeError(
                    f"process {self.process_id}: a peer worker failed: "
                    f"{self._broken}"
                )
            q = self._serve_q[worker_id]
            if not q:
                self._cond.wait(timeout=timeout_s)
            if self._broken is not None:
                raise RuntimeError(
                    f"process {self.process_id}: a peer worker failed: "
                    f"{self._broken}"
                )
            out = list(q)
            q.clear()
        return out

    def _wait(self, key: Any, n: int) -> dict[int, Any]:
        deadline = time.monotonic() + self.collective_timeout_s
        with self._cond:
            while True:
                if self._broken:
                    # _break() notify_all'd this condition, so every blocked
                    # collective in the process unwinds in milliseconds —
                    # never waiting out the collective timeout
                    raise RuntimeError(
                        f"process {self.process_id}: a peer worker failed: "
                        f"{self._broken} (reference cross-worker panic "
                        "propagation, dataflow.rs:5674)"
                    )
                got = self._inbox.get(key)
                if got is not None and len(got) >= n:
                    return dict(got)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted(
                        set(range(self.n_workers)) - set(got or ())
                    )
                    raise RuntimeError(
                        f"process {self.process_id}: cluster collective "
                        f"timed out after {self.collective_timeout_s:.0f}s "
                        f"waiting on {key!r} (no contribution from workers "
                        f"{missing}; set PATHWAY_COLLECTIVE_TIMEOUT_S to "
                        "tune)"
                    )
                self._cond.wait(timeout=min(remaining, 1.0))

    @property
    def bytes_sent(self) -> int:
        return sum(w.bytes_sent for w in self._writers.values())

    @property
    def frames_sent(self) -> int:
        return sum(w.frames_sent for w in self._writers.values())

    def comm_stats(self) -> dict[str, float]:
        # inbox depth = frames delivered by peers but not yet consumed by
        # a local worker's collective — the exchange-queue backpressure
        # signal (a worker falling behind lets its inbox grow); send queue
        # depth = frames encoded but not yet on the wire (a slow PEER or
        # saturated link lets the writer queues grow until the
        # PATHWAY_COMM_QUEUE_FRAMES bound blocks the tick loop)
        bytes_sent = float(self.bytes_sent)
        return {
            "cluster_bytes_sent": bytes_sent,
            "cluster_frames_sent": float(self.frames_sent),
            "cluster_bytes_received": float(self.bytes_received),
            "cluster_frames_received": float(self.frames_received),
            "bytes_total": bytes_sent + float(self.bytes_received),
            "frames_coalesced_total": float(
                sum(w.frames_coalesced for w in self._writers.values())
            ),
            "send_queue_depth": float(
                sum(w.queue_depth() for w in self._writers.values())
            ),
            # the depth's denominator: PATHWAY_COMM_QUEUE_FRAMES per
            # outbound pipeline — depth/capacity is the saturation
            # fraction the autoscaler's scale-up rule watches
            "send_queue_capacity": float(
                self._queue_frames * max(1, len(self._writers))
            ),
            "encode_seconds_total": self.encode_ns / 1e9,
            "cluster_inbox_depth": float(len(self._inbox)),
            "cluster_broken": float(self._broken is not None),
            # frontier-driven plane: events delivered but not yet drained
            # by a local worker — the per-operator input-queue
            # backpressure signal of async execution
            "async_inbox_depth": float(
                sum(len(q) for q in self._async_q.values())
            ),
            "async_inbox_capacity": float(
                self._async_bound * max(1, len(self._async_q))
            ),
            # serve plane: query events delivered but not yet picked up
            # by a responder dispatcher, and events dropped at the bound
            "serve_inbox_depth": float(
                sum(len(q) for q in self._serve_q.values())
            ),
            "serve_dropped_total": float(self._serve_dropped),
        }

    def _break(self, reason: str) -> None:
        """Mark the mesh dead and wake EVERY waiter on the shared condition
        — the one notify_all that turns a 10-minute collective timeout into
        millisecond failure propagation."""
        first = False
        with self._cond:
            if self._broken is None:
                self._broken = reason
                first = True
            self._cond.notify_all()
        # async-plane parks wait on wake events, not the condition — set
        # them all so a frontier-driven loop sees the break immediately
        for waker in self._async_wakers.values():
            waker.set()
        if first:
            # black-box evidence: the crash bundle of a worker that died
            # *because a peer died* should name the peer, not look idle
            from ..observability.flightrecorder import get_recorder

            recorder = get_recorder()
            if recorder is not None:
                recorder.record(
                    "comm.broken", process=self.process_id, reason=reason
                )

    def abort(self) -> None:
        self._break(f"worker on process {self.process_id} failed")
        # peers unblock when their read loops see the closed sockets
        self._shutdown_sockets()

    def close(self) -> None:
        self._closing = True
        for p in list(self._socks):
            try:
                self._send(p, ("bye",))
            except (RuntimeError, OSError, KeyError):
                pass
        # drain the writer pipelines before tearing sockets down: queued
        # frames (including the byes) must reach peers still blocked in
        # their final collectives
        for w in self._writers.values():
            w.close()
        for w in self._writers.values():
            w.join(5.0)
        self._shutdown_sockets()

    def _shutdown_sockets(self) -> None:
        self._closing = True
        for s in self._socks.values():
            # shutdown() before close(): close() alone neither interrupts a
            # recv in flight on this socket nor sends the FIN that would
            # wake the PEER's reader — shutdown does both, which is what
            # makes failure propagation immediate instead of timeout-bound
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass


def _address_book(
    addresses: list[str] | None, n: int, host: str, first_port: int
) -> list[tuple[str, int]]:
    """Resolve per-process (host, port). ``addresses`` entries are
    ``host[:port]``; a bare host gets ``first_port + pid`` (so a hostfile of
    machine names works unchanged, like timely's)."""
    if addresses is None:
        return [(host, first_port + p) for p in range(n)]
    if len(addresses) != n:
        raise ValueError(
            f"address book lists {len(addresses)} hosts for {n} processes"
        )
    book: list[tuple[str, int]] = []
    for p, entry in enumerate(addresses):
        h, port = _parse_address(entry, first_port + p)
        book.append((h, port))
    return book


def _parse_address(entry: str, default_port: int) -> tuple[str, int]:
    """``host``, ``host:port``, ``[v6]:port``, or a bare IPv6 literal."""
    if entry.startswith("["):  # [::1]:port
        h, bracket, rest = entry[1:].partition("]")
        if not bracket or not h:
            raise ValueError(f"malformed address {entry!r}")
        if not rest:
            return h, default_port
        if not rest.startswith(":"):
            raise ValueError(f"malformed address {entry!r}")
        port_s = rest[1:]
    elif entry.count(":") > 1:  # bare IPv6 literal, no port
        return entry, default_port
    elif ":" in entry:
        h, _, port_s = entry.rpartition(":")
    else:
        return entry, default_port
    if not h:
        raise ValueError(f"address {entry!r} has an empty host")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"address {entry!r} has a non-numeric port") from None
    if not 0 < port < 65536:
        raise ValueError(f"address {entry!r} port out of range")
    return h, port


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    return bytes(_recv_into(sock, n))


#: frames up to this size recv into ONE preallocated buffer (every sane
#: exchange frame); past it, memory grows only as bytes actually arrive,
#: so a corrupt length prefix under the sanity cap can never OOM the
#: process with a giant zero-filled allocation
_RECV_PREALLOC_MAX = 64 << 20


def _recv_into(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes into one buffer — the recv buffer the
    columnar decoder's ``frombuffer`` arrays alias (a bytearray, so
    decoded columns stay ordinary writable arrays)."""
    if n <= _RECV_PREALLOC_MAX:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            r = sock.recv_into(view[got:])
            if not r:
                raise EOFError("socket closed")
            got += r
        return buf
    # huge frame (or a garbage length that slipped the sanity bound):
    # grow with the data, one bounded scratch buffer at a time
    buf = bytearray()
    scratch = bytearray(_RECV_PREALLOC_MAX)
    sv = memoryview(scratch)
    remaining = n
    while remaining:
        r = sock.recv_into(sv[: min(_RECV_PREALLOC_MAX, remaining)])
        if not r:
            raise EOFError("socket closed")
        buf += sv[:r]
        remaining -= r
    return buf
