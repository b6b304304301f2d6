"""Multi-process runs of the port under ``python -m pathway_tpu_torch.cli spawn -n 2``, on the
CPU, each held against the JAX package's one-worker table of the same program.

- ``MultiHostMeshComm`` at ``-n 2 -t 2``, ``-n 2 -t 1`` and ``-n 4 -t 2``
  (``PATHWAY_MESH_EXCHANGE=1``): the dense columns bucketed in each process and swapped over
  gloo (the reference skips its own CPU case); the swap's transport chosen by the placement;
- the streaming wordcount at ``-n 2`` over ``ClusterComm``, async (the shape of
  ``tests/test_async_exec.py::test_cluster_n2_async``) and BSP;
- ``spawn --supervise -n 2``: process 0 SIGKILLs itself mid-stream in generation 0 and the
  ensemble restarts from its snapshots (the shape of
  ``tests/test_supervise.py::test_sharded_sigkill_supervised_recovery``, without a fault plan);
- ``spawn -n 2 --record`` then ``replay -n 2``;
- ``trace merge`` of the two processes' parts (the shape of ``tests/test_tracing.py``'s
  two-process case), the merged document held equal to the reference's merge of the same parts;
- a persisted store written at ``-n 2``, rescaled offline to one worker and elastically to three;
- process 0's monitoring roll-up over its peer (the hub's peer book), and ``top``'s frame of
  it.

Every cluster takes its ports below the ephemeral range (``tests/torch_ports.py``); every child
has a timeout of its own. Tolerance: none; tables are compared exactly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
import urllib.request

import pytest

from torch_ports import port_block

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "pathway_tpu_torch"
#: seconds a spawned ensemble may take
CHILD_TIMEOUT = 240

#: the groupby + join of tests/test_sharded.py's cluster program; process 0 writes its table
JOIN_PROGRAM = '''
import json, logging, os, sys
from collections import Counter

import {pkg} as pw
from {pkg}.testing import T, _norm

logging.basicConfig(level=logging.INFO)
lines = ["k | v"] + [f"g{{i % 7}} | {{i}}" for i in range(64)]
t = T("\\n".join(lines))
counts = t.groupby(pw.this.k).reduce(
    pw.this.k, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count()
)
names = T("\\n".join(["k | label"] + [f"g{{i}} | L{{i}}" for i in range(7)]))
res = counts.join(names, counts.k == names.k).select(pw.right.label, s=pw.left.s, c=pw.left.c)
acc = Counter()
cols = res.column_names()
pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: acc.update(
    {{tuple(_norm(row[c]) for c in cols): 1 if is_addition else -1}}))
pw.run({run_kw})
if int(os.environ.get("PATHWAY_PROCESS_ID", "0")) == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(sorted([list(k), v] for k, v in acc.items() if v), f)
'''

#: a streaming wordcount over a python subject: argv out, rows, batch
STREAM_PROGRAM = '''
import json, os, sys

import {pkg} as pw

n_rows, batch = int(sys.argv[2]), int(sys.argv[3])
words = [f"w{{i % 97}}" for i in range(n_rows)]


class Feed(pw.io.python.ConnectorSubject):
    def run(self):
        for s in range(0, n_rows, batch):
            self.next_batch({{"word": words[s:s + batch]}})
            self.commit()


t = pw.io.python.read(Feed(), schema=pw.schema_from_types(word=str),
                      autocommit_duration_ms=None, name="words")
counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
net = {{}}


def on_change(key, row, time, is_addition):
    k = (row["word"], int(row["c"]))
    net[k] = net.get(k, 0) + (1 if is_addition else -1)


pw.io.subscribe(counts, on_change=on_change)
pw.run({run_kw})
if int(os.environ.get("PATHWAY_PROCESS_ID", "0")) == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(sorted([w, c] for (w, c), v in net.items() if v > 0), f)
'''

#: a persisted wordcount: argv out (events), store, words to send, the row after which a
#: supervised generation 0 SIGKILLs process 0 (0: never)
PERSISTED_PROGRAM = '''
import glob, json, os, signal, sys, time

import {pkg} as pw
from {pkg}.persistence import Backend, Config

out_path, pstate, n_words, kill_at = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
gen = os.environ.get("PATHWAY_RESTART_COUNT")
pid = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
if pid == 0:
    with open(out_path, "a") as f:
        f.write(json.dumps(["gen", gen]) + "\\n")
WORDS = [["foo", "bar", "foo", "baz"][i % 4] + str(i % 7) for i in range(n_words)]
killing = kill_at and os.environ.get("PATHWAY_SUPERVISED") == "1" and gen == "0" and pid == 0


def covered() -> int:
    best = 0
    for name in glob.glob(os.path.join(pstate, "worker-*", "meta", "*")):
        if ".tmp" in name:
            continue
        try:
            with open(name) as f:
                best = max(best, json.load(f)["offsets"].get("words", {{}}).get("rows", 0))
        except (OSError, ValueError, KeyError):
            continue
    return best


class S(pw.io.python.ConnectorSubject):
    def run(self):
        for i, w in enumerate(WORDS):
            self.next(word=w)
            self.commit()
            time.sleep(0.01)
            if killing and i + 1 == kill_at:
                deadline = time.monotonic() + 60
                while covered() < kill_at // 2 and time.monotonic() < deadline:
                    time.sleep(0.01)
                os.kill(os.getpid(), signal.SIGKILL)


t = pw.io.python.read(S(), schema=pw.schema_from_types(word=str), name="words",
                      autocommit_duration_ms=None)
counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
f = open(out_path, "a")


def on_change(key, row, time, is_addition):
    f.write(json.dumps([row["word"], int(row["c"]), bool(is_addition)]) + "\\n")
    f.flush()


pw.io.subscribe(counts, on_change=on_change)
pw.run({run_kw}persistence_config=Config.simple_config(Backend.filesystem(pstate),
                                                       snapshot_interval_ms=10))
'''


def _write(tmp_path, name: str, template: str, pkg: str) -> str:
    path = tmp_path / f"{name}_{pkg}.py"
    run_kw = 'device="cpu", ' if pkg == PORT else ""
    path.write_text(textwrap.dedent(template).format(pkg=pkg, run_kw=run_kw).replace(
        ", )", ")"))
    return str(path)


def _env(**extra: str) -> dict:
    env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    for k in ("PATHWAY_THREADS", "PATHWAY_PROCESSES", "PATHWAY_PROCESS_ID", "PATHWAY_ASYNC_EXEC",
              "PATHWAY_MESH_EXCHANGE", "PATHWAY_TRACE_FILE", "PATHWAY_FIRST_PORT",
              "PATHWAY_ADDRESSES", "PATHWAY_MONITORING_HTTP_SERVER", "PATHWAY_ELASTIC"):
        env.pop(k, None)
    return {**env, **extra}


def _spawn(argv: list[str], env: dict, cwd=None) -> subprocess.CompletedProcess:
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.cli", *argv], env=env,
                       cwd=cwd, capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    return r


def _reference(program: str, *args: str) -> list:
    """The JAX package's one-worker table of ``program`` (its own run, in a fresh process)."""
    out = program + ".reference.json"
    subprocess.run([sys.executable, program, out, *args], env=_env(), check=True,
                   timeout=CHILD_TIMEOUT, capture_output=True)
    with open(out) as f:
        return json.load(f)


def _events(path) -> list:
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:  # a SIGKILL may tear the last line
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


def _final(events: list) -> dict:
    final: dict = {}
    for e in events:
        if e[0] == "gen":
            continue
        word, c, add = e
        if add:
            final[word] = c
        elif final.get(word) == c:
            del final[word]
    return final


@pytest.mark.parametrize("processes,threads", [(2, 2), (2, 1), (4, 2)],
                         ids=["2x2", "2x1", "4x2"])
def test_multihost_mesh_exchange_parity(tmp_path, processes, threads):
    """``spawn -n P -t T`` with ``PATHWAY_MESH_EXCHANGE=1``: each process's leader buckets its
    workers' dense rows for every worker of the cluster, and the leaders swap them over gloo
    (the processes share the host)."""
    ours = _write(tmp_path, "join", JOIN_PROGRAM, PORT)
    first = port_block()
    r = _spawn(["spawn", "-n", str(processes), "-t", str(threads), "--first-port", str(first),
                sys.executable, ours, str(tmp_path / "mesh.json")],
               _env(PATHWAY_MESH_EXCHANGE="1"))
    assert "gloo swap" in r.stderr and "nccl swap" not in r.stderr, r.stderr[-2000:]
    got = json.loads((tmp_path / "mesh.json").read_text())
    want = _reference(_write(tmp_path, "join", JOIN_PROGRAM, "pathway_tpu"))
    assert got == want and len(want) == 7


@pytest.mark.parametrize("device_type,placements,want", [
    ("cuda", [("h", "GPU-a"), ("h", "GPU-b")], "nccl"),
    ("cuda", [("h", "GPU-a"), ("h", "GPU-a")], "gloo"),
    ("cuda", [("h1", "GPU-a"), ("h2", "GPU-a")], "nccl"),
    ("cpu", [("h", "cpu"), ("h", "cpu")], "gloo"),
], ids=["own-cards", "shared-card", "two-hosts", "cpu"])
def test_swap_transport_is_chosen_by_placement(device_type, placements, want):
    from pathway_tpu_torch.parallel.meshcomm import choose_transport

    assert choose_transport(device_type, placements) == want


@pytest.mark.parametrize("async_exec", ["1", "0"], ids=["async", "bsp"])
def test_streaming_wordcount_at_two_processes(tmp_path, async_exec):
    ours = _write(tmp_path, "stream", STREAM_PROGRAM, PORT)
    r = _spawn(["spawn", "-n", "2", "-t", "1", "--first-port", str(port_block()),
                sys.executable, ours, str(tmp_path / "out.json"), "4000", "500"],
               _env(PATHWAY_ASYNC_EXEC=async_exec))
    got = json.loads((tmp_path / "out.json").read_text())
    want = _reference(_write(tmp_path, "stream", STREAM_PROGRAM, "pathway_tpu"), "4000", "500")
    assert got == want and sum(c for _, c in want) == 4000, r.stderr[-2000:]


def test_supervised_recovery_of_two_processes(tmp_path):
    n_words, kill_at = 60, 24
    ours = _write(tmp_path, "persisted", PERSISTED_PROGRAM, PORT)
    out = tmp_path / "events.jsonl"
    r = _spawn(["spawn", "--supervise", "-n", "2", "-t", "1", "--first-port", str(port_block()),
                sys.executable, ours, str(out), str(tmp_path / "pstate"), str(n_words),
                str(kill_at)],
               _env(PATHWAY_FLIGHT_DIR=str(tmp_path / "flight"),
                    PATHWAY_SUPERVISE_BACKOFF_S="0.05", PATHWAY_SUPERVISE_BACKOFF_MAX_S="0.2"))
    events = _events(out)
    gens = [e for e in events if e[0] == "gen"]
    assert [g[1] for g in gens] == ["0", "1"], r.stderr[-3000:]
    upto = events.index(gens[1])
    ref_out = tmp_path / "reference.jsonl"
    subprocess.run([sys.executable, _write(tmp_path, "persisted", PERSISTED_PROGRAM,
                                           "pathway_tpu"),
                    str(ref_out), str(tmp_path / "ref_pstate"), str(n_words), "0"],
                   env=_env(), check=True, timeout=CHILD_TIMEOUT, capture_output=True)
    want = _final(_events(ref_out))
    assert _final(events[:upto]) != want  # the kill landed mid-stream
    assert _final(events) == want and sum(want.values()) == n_words
    # each process persisted its own worker's namespace
    assert {"worker-0", "worker-1"} <= set(os.listdir(tmp_path / "pstate"))
    assert "process 0" in r.stderr


def test_record_then_replay_at_two_processes(tmp_path):
    ours = _write(tmp_path, "stream", STREAM_PROGRAM, PORT)
    rec = str(tmp_path / "record")
    _spawn(["spawn", "-n", "2", "--record", "--record-path", rec, "--first-port",
            str(port_block()), sys.executable, ours, str(tmp_path / "rec.json"), "2000", "250"],
           _env(PATHWAY_ASYNC_EXEC="0"), cwd=tmp_path)
    _spawn(["replay", "-n", "2", "--record-path", rec, "--mode", "speedrun", sys.executable, ours,
            str(tmp_path / "replay.json"), "0", "250"],
           _env(PATHWAY_ASYNC_EXEC="0", PATHWAY_FIRST_PORT=str(port_block())), cwd=tmp_path)
    want = _reference(_write(tmp_path, "stream", STREAM_PROGRAM, "pathway_tpu"), "2000", "250")
    assert json.loads((tmp_path / "rec.json").read_text()) == want
    assert json.loads((tmp_path / "replay.json").read_text()) == want


def test_trace_merge_of_two_processes(tmp_path):
    from pathway_tpu.observability.trace_merge import merge_trace as reference_merge

    ours = _write(tmp_path, "stream", STREAM_PROGRAM, PORT)
    base = tmp_path / "trace.json"
    _spawn(["spawn", "-n", "2", "-t", "1", "--first-port", str(port_block()), sys.executable,
            ours, str(tmp_path / "out.json"), "1000", "250"],
           _env(PATHWAY_TRACE_FILE=str(base)))
    docs = {}
    for p in (0, 1):
        docs[p] = json.loads((tmp_path / f"trace.json.p{p}").read_text())
        names = {e["name"] for e in docs[p]["traceEvents"]}
        assert "engine.run" in names and "tick" in names, sorted(names)
    starts = {(e["id"], p) for p in docs for e in docs[p]["traceEvents"] if e.get("ph") == "s"}
    ends = {(e["id"], p) for p in docs for e in docs[p]["traceEvents"] if e.get("ph") == "f"}
    assert {i for i, p in starts for j, q in ends if i == j and p != q}, "no cross-process flow"
    run_ids = {e["args"]["run_id"] for p in docs for e in docs[p]["traceEvents"]
               if e["name"] == "trace.clock_sync"}
    assert len(run_ids) == 1

    r = _spawn(["trace", "merge", str(base), "-o", str(tmp_path / "merged.json")], _env())
    merged = json.loads((tmp_path / "merged.json").read_text())
    assert {e["pid"] for e in merged["traceEvents"] if e.get("ph") != "M"} == {0, 1}, r.stdout
    path, _ = reference_merge(str(base), output=str(tmp_path / "reference.json"))
    with open(path) as f:
        assert json.load(f) == merged
    want = _reference(_write(tmp_path, "stream", STREAM_PROGRAM, "pathway_tpu"), "1000", "250")
    assert json.loads((tmp_path / "out.json").read_text()) == want


@pytest.mark.parametrize("how", ["offline-to-1", "elastic-to-3"])
def test_store_written_at_two_processes_rescales(tmp_path, how):
    """The first 30 words persisted by ``-n 2``; then all 60 words, after ``rescale --to 1`` at
    one worker, or through ``spawn --elastic -n 3`` (worker 0 reshards the store in process 0
    while processes 1 and 2 wait)."""
    ours = _write(tmp_path, "persisted", PERSISTED_PROGRAM, PORT)
    store = str(tmp_path / "pstate")
    out_a, out_b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _spawn(["spawn", "-n", "2", "-t", "1", "--first-port", str(port_block()), sys.executable,
            ours, str(out_a), store, "30", "0"], _env())
    if how == "offline-to-1":
        r = _spawn(["rescale", store, "--to", "1"], _env())
        report = json.loads(r.stdout.strip().splitlines()[-1])
        assert (report["from"], report["to"]) == (2, 1), report
        subprocess.run([sys.executable, ours, str(out_b), store, "60", "0"], env=_env(),
                       check=True, timeout=CHILD_TIMEOUT, capture_output=True)
    else:
        _spawn(["spawn", "--elastic", "-n", "3", "-t", "1", "--first-port", str(port_block()),
                sys.executable, ours, str(out_b), store, "60", "0"], _env())
    ref_out = tmp_path / "reference.jsonl"
    subprocess.run([sys.executable, _write(tmp_path, "persisted", PERSISTED_PROGRAM,
                                           "pathway_tpu"),
                    str(ref_out), str(tmp_path / "ref_pstate"), "60", "0"],
                   env=_env(), check=True, timeout=CHILD_TIMEOUT, capture_output=True)
    final = _final(_events(out_a))
    final.update(_final(_events(out_b)))
    assert final == _final(_events(ref_out))


_ROLLUP_PROGRAM = '''
import os, sys, time

import pathway_tpu_torch as pw

release = sys.argv[1]


class S(pw.io.python.ConnectorSubject):
    def run(self):
        for i in range(200):
            self.next(word=f"w{i % 13}")
        self.commit()
        while not os.path.exists(release):
            time.sleep(0.05)


t = pw.io.python.read(S(), schema=pw.schema_from_types(word=str), autocommit_duration_ms=None)
counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
pw.io.subscribe(counts, on_change=lambda **kw: None)
pw.run(device="cpu")
'''


def test_process_zero_rolls_up_its_peer(tmp_path):
    """With the monitoring server on, each process serves its own worker on ``base +
    process_id``, and process 0's ``/metrics`` is the merged view of both (the hub's peer
    book)."""
    prog = tmp_path / "rollup.py"
    prog.write_text(_ROLLUP_PROGRAM)
    release = tmp_path / "release"
    base = port_block()  # process p serves on base + p
    proc = subprocess.Popen(
        [sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "-n", "2", "-t", "1",
         "--first-port", str(port_block()), sys.executable, str(prog), str(release)],
        env=_env(PATHWAY_MONITORING_HTTP_SERVER="1", PATHWAY_MONITORING_HTTP_PORT=str(base)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    from pathway_tpu_torch.observability.top import fetch_query, render_frame

    texts, frame = {}, ""
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                for p in (0, 1):
                    with urllib.request.urlopen(f"http://127.0.0.1:{base + p}/metrics",
                                                timeout=5) as r:
                        texts[p] = r.read().decode()
                # top's frame over process 0's merged /query, once the signals plane of
                # each process has sampled its worker
                frame = render_frame(fetch_query(f"http://127.0.0.1:{base}/query"))
                if 'worker="1"' in texts[0] and "2 worker(s)" in frame:
                    break
            except OSError:
                pass
            time.sleep(0.2)
    finally:
        release.write_text("")
        _, err = proc.communicate(timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    assert 'worker="0"' in texts[0] and 'worker="1"' in texts[0], texts.get(0, "")[-2000:]
    assert 'worker="1"' in texts[1] and 'worker="0"' not in texts[1]
    assert "2 worker(s)" in frame, frame


def test_hub_peer_book_matches_the_reference(monkeypatch):
    from pathway_tpu.internals.config import get_pathway_config as reference_config
    from pathway_tpu.observability.hub import ObservabilityHub as ReferenceHub
    from pathway_tpu_torch.internals.config import get_pathway_config
    from pathway_tpu_torch.observability.hub import ObservabilityHub

    monkeypatch.setenv("PATHWAY_PROCESSES", "3")
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", "21000")
    for pid, book in ((0, None), (1, None), (0, "hostA:1,[::1]:2,hostC")):
        monkeypatch.setenv("PATHWAY_PROCESS_ID", str(pid))
        if book:
            monkeypatch.setenv("PATHWAY_ADDRESSES", book)
        ours = ObservabilityHub.from_config(get_pathway_config())
        theirs = ReferenceHub.from_config(reference_config())
        assert ours.peer_http == theirs.peer_http
        assert bool(ours.peer_http) == (pid == 0)


_NO_JAX = textwrap.dedent("""
    import importlib.abc
    import sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "pathway_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import pathway_tpu_torch.graft_entry as ge
    import pathway_tpu_torch.models.pipeline
    import pathway_tpu_torch.parallel.cluster as cluster
    import pathway_tpu_torch.parallel.meshcomm
    from pathway_tpu_torch.parallel.distributed import init_from_env

    comm = cluster.ClusterComm(process_id=0, n_processes=1, threads_per_process=1, first_port=1)
    comm.close()
    init_from_env(device="cpu")
    fn, args = ge.entry(device="cpu")
    assert tuple(fn(*args).shape) == (8, 128)
    out = ge.dryrun_multichip(1, device="cpu")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pathway_tpu"))
    assert not loaded, loaded
    print("NO-JAX-OK", out["dataflow"], out["recovery"])
""")


def test_cluster_mesh_step_and_graft_entry_load_no_jax():
    r = subprocess.run([sys.executable, "-c", _NO_JAX], env=_env(), capture_output=True,
                       text=True, timeout=CHILD_TIMEOUT, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO-JAX-OK (2, 7) (2, 5)" in r.stdout
