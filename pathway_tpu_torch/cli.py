"""The port's command line (reference ``python/pathway/cli.py:53-280``):
``spawn`` launches a program with the worker environment set (``--record``
captures its input for ``replay``, ``--supervise`` restarts it from its last
snapshot when it dies, ``--elastic`` reshards its state at boot);
``replay`` re-runs a program against recorded input; ``rescale``
repartitions a persisted store to a new worker count; ``top``,
``critpath`` and ``profile`` read a running pipeline's monitoring server;
``dlq`` lists the delivery sinks' dead letters; ``lint`` analyses pipeline
scripts without running them; ``trace merge`` assembles the
``PATHWAY_TRACE_FILE`` parts of a run into one Perfetto timeline.

Run as ``python -m pathway_tpu_torch.cli`` or the ``pathway-tpu-torch`` entry
point; ``main(argv)`` runs one command in process and returns its exit code.

Copy of ``pathway_tpu/cli.py`` over the standard library's ``argparse`` in
place of ``click``, with the reference's commands, options, defaults, help,
output and exit codes: a refused command prints ``Error: <message>`` on
stderr and exits 1, a usage error exits 2, ``lint`` exits 0-3, ``spawn`` and
``replay`` exit with the program's code and ``spawn --supervise`` with the
supervisor's. ``spawn`` and ``replay`` run the program unchanged: its own
``pw.run()`` chooses the device (``"cuda"`` unless it passes another), so
they take no device of their own. ``lint`` lowers each script's graph in
this process, on ``--device`` (default ``cuda``).

Refused until the modules they need are ported, each naming its
``ROADMAP.md`` item: ``spawn``/``replay`` over more than one process
(``-n`` > 1, ``--addresses``, ``-p``: the cluster, Queue 1 item 9), and
``spawn --autoscale``, ``spawn --upgrade-to`` and ``upgrade`` (Queue 1 item
13's last part: ``autoscale/``, ``upgrade/``).
"""

from __future__ import annotations

import argparse
import os
import secrets
import subprocess
import sys

from .internals.config import MAX_WORKERS

__all__ = [
    "main", "spawn", "replay", "rescale", "upgrade", "top", "critpath",
    "profile", "trace_merge", "dlq", "lint", "CommandError",
]

#: why the multi-process options refuse
_CLUSTER_ITEM = (
    "the multi-process cluster (parallel/cluster.py) is not ported "
    "(ROADMAP.md Queue 1 item 9)"
)
#: why the autoscale and upgrade options refuse
_LAST_PART_ITEM = (
    "is not ported (ROADMAP.md Queue 1 item 13, its last part: upgrade/, "
    "autoscale/, chaos/, astgate.py)"
)


class CommandError(Exception):
    """A refused command: ``Error: <message>`` on stderr, exit code 1 (the
    reference's ``click.ClickException``)."""


def _echo(text: str = "", err: bool = False) -> None:
    print(text, file=sys.stderr if err else sys.stdout, flush=True)


def _spawn_processes(
    threads: int,
    processes: int,
    first_port: int,
    env_extra: dict,
    args: list[str],
    supervise: bool = False,
) -> int:
    if threads * processes > MAX_WORKERS:
        raise CommandError(
            f"{threads}×{processes} workers exceed the {MAX_WORKERS}-worker limit"
        )
    if processes > 1:
        raise CommandError(f"-n {processes}: {_CLUSTER_ITEM}")
    program = list(args)
    if not program:
        raise CommandError("pass the program to run, e.g. python app.py")
    base_env = {
        **os.environ,
        "PATHWAY_THREADS": str(threads),
        "PATHWAY_PROCESSES": str(processes),
        "PATHWAY_FIRST_PORT": str(first_port),
        **env_extra,
    }
    # one run identity for the whole run: tracers mint flow ids under it
    # and `trace merge` refuses to mix different runs
    base_env.setdefault("PATHWAY_RUN_ID", secrets.token_hex(8))
    if supervise:
        return _run_supervised(base_env, program, [0])
    env = {**base_env, "PATHWAY_PROCESS_ID": "0"}
    return subprocess.call(program, env=env)


def _run_supervised(
    base_env: dict, program: list[str], pids: list[int]
) -> int:
    """Run the ensemble under a Supervisor: on any child death, tear the
    survivors down cooperatively and relaunch the WHOLE generation (the
    engine recovers from the last snapshot common to every worker). See
    parallel/supervisor.py for the backoff/circuit-breaker contract."""
    from .parallel.supervisor import Supervisor

    # always-on black box under supervision: each child keeps an mmap ring
    # of its last ticks (observability/flightrecorder.py) which the
    # supervisor harvests into crash-<gen>-<proc>.json bundles on failure
    base_env.setdefault(
        "PATHWAY_FLIGHT_DIR", os.path.join(os.getcwd(), "pathway-flight")
    )

    def launch(generation: int, reason: str | None):
        # late-binds `sup` below; Supervisor.run() only calls launch()
        # after construction completes
        env = {**base_env, **sup.child_env(generation, reason)}
        return [
            subprocess.Popen(
                program, env={**env, "PATHWAY_PROCESS_ID": str(pid)}
            )
            for pid in pids
        ]

    health_ports: list[int] = []
    if base_env.get("PATHWAY_MONITORING_HTTP_SERVER", "").strip().lower() in (
        "1", "true", "yes", "on"
    ):
        try:
            base = int(
                base_env.get("PATHWAY_MONITORING_HTTP_PORT", "20000") or 0
            )
        except ValueError:
            # same tolerance as config._env_int/http_server: a malformed
            # port degrades to exit-code-only supervision, never a crash
            base = 0
        if base:
            health_ports = [base + pid for pid in pids]
    sup = Supervisor(
        launch,
        health_ports=health_ports,
        labels=[f"process {pid}" for pid in pids],
        flight_dir=base_env.get("PATHWAY_FLIGHT_DIR"),
        process_ids=pids,
        run_id=base_env.get("PATHWAY_RUN_ID"),
    )
    return sup.run()


def _program(args: list[str]) -> list[str]:
    """The program's argv: everything after the command's own options, a
    leading ``--`` dropped."""
    return args[1:] if args[:1] == ["--"] else list(args)


def spawn(a: argparse.Namespace) -> int:
    """Launch PROGRAM with the worker environment set (reference cli.py:53)."""
    if a.addresses is not None:
        raise CommandError(f"--addresses: {_CLUSTER_ITEM}")
    if a.local_ids:
        raise CommandError(f"-p/--process: {_CLUSTER_ITEM}")
    if a.autoscale_range is not None:
        raise CommandError(f"--autoscale: autoscale/ {_LAST_PART_ITEM}")
    if a.upgrade_to is not None:
        raise CommandError(f"--upgrade-to: upgrade/ {_LAST_PART_ITEM}")
    env_extra: dict[str, str] = {}
    if a.record:
        env_extra["PATHWAY_REPLAY_STORAGE"] = a.record_path
        env_extra["PATHWAY_SNAPSHOT_ACCESS"] = "record"
    if a.elastic:
        env_extra["PATHWAY_ELASTIC"] = "1"
    return _spawn_processes(a.threads, a.processes, a.first_port, env_extra,
                            _program(a.program), supervise=a.supervise)


def replay(a: argparse.Namespace) -> int:
    """Re-run PROGRAM against recorded input (reference cli.py:194)."""
    env_extra = {
        "PATHWAY_REPLAY_STORAGE": a.record_path,
        "PATHWAY_SNAPSHOT_ACCESS": "replay",
        "PATHWAY_PERSISTENCE_MODE": a.mode,
    }
    if a.continue_after_replay:
        env_extra["PATHWAY_CONTINUE_AFTER_REPLAY"] = "1"
    return _spawn_processes(a.threads, a.processes, 10000, env_extra,
                            _program(a.program))


def rescale(a: argparse.Namespace) -> int:
    """Repartition persisted cluster state to --to workers."""
    import json as _json

    from .persistence import Backend
    from .rescale import RescaleError, rescale as _rescale

    if a.to_workers <= 0:
        # refuse before touching the store: a nonsensical target must not
        # depend on what (if anything) is persisted at STORE
        raise CommandError(
            f"refusing --to {a.to_workers}: the target worker count must be "
            ">= 1 (state is hash-sharded across workers; zero shards hold "
            "nothing)"
        )
    spec = (
        Backend.filesystem(a.store)
        if a.backend_kind == "filesystem"
        else Backend.s3(a.store)
    )
    try:
        report = _rescale(
            spec, a.to_workers,
            log=lambda m: _echo(m, err=True), dry_run=a.dry_run,
        )
    except RescaleError as e:
        raise CommandError(str(e))
    if report.get("noop"):
        _echo(
            f"store is already laid out for {a.to_workers} worker(s) — "
            "nothing to do"
            + (" (dry run)" if a.dry_run else "")
        )
    elif a.dry_run:
        from .rescale.render import render_dry_run

        for line in render_dry_run(report):
            _echo(line)
        _echo(_json.dumps(report))
    else:
        _echo(_json.dumps(report))
    return 0


def upgrade(a: argparse.Namespace) -> int:
    """Migrate persisted state at STORE to the graph NEW_SCRIPT builds."""
    raise CommandError(f"upgrade: upgrade/ {_LAST_PART_ITEM}")


def _monitor_url(url: str | None, host: str, port: int | None,
                 route: str) -> str:
    """``url`` as given (its route appended when missing, except for
    ``top``), else ``http://host:port/route`` with the port defaulting to
    PATHWAY_MONITORING_HTTP_PORT or 20000."""
    if url is None:
        if port is None:
            try:
                port = int(
                    os.environ.get("PATHWAY_MONITORING_HTTP_PORT", "20000")
                )
            except ValueError:
                port = 20000
        return f"http://{host}:{port}/{route}"
    return url


def top(a: argparse.Namespace) -> int:
    """Live cluster dashboard over the /query signals endpoint."""
    from .observability.top import run_top

    url = _monitor_url(a.url, a.host, a.port, "query")
    return run_top(url, interval_s=a.interval, frames=a.frames,
                   clear=not a.no_clear)


def critpath(a: argparse.Namespace) -> int:
    """Commit-wave critical-path report over the /query endpoint."""
    import json as _json

    from .observability.critpath import render_report
    from .observability.top import fetch_query

    url = _monitor_url(a.url, a.host, a.port, "query")
    if a.url is not None and not url.rstrip("/").endswith("/query"):
        url = url.rstrip("/") + "/query"
    try:
        doc = fetch_query(url)
    except Exception as e:
        raise CommandError(f"{url} unreachable ({e})")
    waves = doc.get("waves")
    if a.as_json:
        _echo(_json.dumps(waves, indent=2, sort_keys=True))
        return 0
    _echo(render_report(waves, top_k=a.top_k))
    return 0


def profile(a: argparse.Namespace) -> int:
    """Cluster-merged flamegraph from the continuous profiler."""
    import json as _json
    import urllib.request

    from .observability.profile_merge import render_top

    if a.as_speedscope and a.as_collapsed:
        raise CommandError("--speedscope and --collapsed are exclusive")
    url = _monitor_url(a.url, a.host, a.port, "profile")
    if a.url is not None and not url.rstrip("/").endswith("/profile"):
        url = url.rstrip("/") + "/profile"
    params = [f"mode={a.mode}"]
    if a.as_heap:
        params = ["heap=1"]
    elif a.as_speedscope:
        params.append("format=speedscope")
    elif a.as_collapsed:
        params.append("format=collapsed")
    if a.local_only and not a.as_heap:
        params.append("local=1")
    full = url + "?" + "&".join(params)
    try:
        with urllib.request.urlopen(full, timeout=10.0) as r:
            body = r.read().decode()
    except Exception as e:
        raise CommandError(f"{full} unreachable ({e})")
    if a.as_collapsed:
        text = body
    elif a.as_speedscope or a.as_heap:
        text = _json.dumps(_json.loads(body), indent=2, sort_keys=True)
    else:
        text = render_top(_json.loads(body), n=a.top_n, mode=a.mode)
    if a.output:
        with open(a.output, "w", encoding="utf-8") as f:
            f.write(text if text.endswith("\n") else text + "\n")
        _echo(f"wrote {a.output}")
    else:
        _echo(text)
    return 0


def dlq(a: argparse.Namespace) -> int:
    """Inspect the sink dead-letter queue (poison rows the delivery layer
    refused to drop silently)."""
    import json as _json

    root = a.dlq_dir or os.environ.get("PATHWAY_SINK_DLQ_DIR", "./pathway-dlq")
    if not os.path.isdir(root):
        raise CommandError(f"no dead-letter directory at {root}")
    files = sorted(
        f for f in os.listdir(root)
        if f.endswith(".jsonl")
        and (a.sink_name is None or f == f"{a.sink_name}.jsonl")
    )
    if not files:
        raise CommandError(
            f"no dead-letter files in {root}"
            + (f" for sink {a.sink_name!r}" if a.sink_name else "")
        )
    total = 0
    for fn in files:
        path = os.path.join(root, fn)
        entries = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        entries.append(_json.loads(line))
                    except ValueError:
                        entries.append({"error": "<unparseable entry>"})
        total += len(entries)
        _echo(f"{fn[:-6]}: {len(entries)} dead-lettered row(s) ({path})")
        for e in entries[-a.tail_n:] if a.tail_n else []:
            _echo(
                f"  t={e.get('time')} stamp={e.get('stamp')} "
                f"error={e.get('error')!r} row={_json.dumps(e.get('row'))}"
            )
    _echo(f"total: {total} row(s) across {len(files)} sink(s)")
    return 0


def lint(a: argparse.Namespace) -> int:
    """Statically analyze pipeline scripts without running them."""
    import json as _json

    from .analysis.lint import lint_targets

    results, code = lint_targets(
        list(a.targets), n_workers=a.n_workers, fail_on=a.fail_on,
        device=a.device,
    )
    if a.as_json:
        _echo(_json.dumps([r["doc"] for r in results], indent=2))
    else:
        for r in results:
            if r["crash"] is not None:
                _echo(
                    f"== pathway-tpu lint: {r['report'].script} ==\n"
                    f"script crashed while building its graph: "
                    f"{r['doc']['crash']}",
                    err=True,
                )
            else:
                _echo(r["report"].render(fingerprints=not a.no_fingerprints))
    return code


def trace_merge(a: argparse.Namespace) -> int:
    """Merge per-process trace parts into one cluster timeline."""
    from .observability.trace_merge import merge_trace

    try:
        out_path, report = merge_trace(
            a.base, output=a.output, allow_mixed_runs=a.allow_mixed_runs
        )
    except (OSError, ValueError) as e:
        raise CommandError(str(e))
    _echo(
        f"merged {report['n_parts']} part(s), {report['n_events']} events "
        f"({report['n_flows']} flow events) -> {out_path}"
    )
    return 0


def _monitor_options(p: argparse.ArgumentParser, route: str) -> None:
    p.add_argument("--url", type=str, default=None,
                   help=f"full /{route} URL (overrides --host/--port)")
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="monitoring host of process 0")
    p.add_argument("--port", type=int, default=None,
                   help="monitoring port of process 0 (default "
                        "PATHWAY_MONITORING_HTTP_PORT or 20000)")


def _existing_path(value: str) -> str:
    if not os.path.exists(value):
        raise argparse.ArgumentTypeError(f"Path {value!r} does not exist.")
    return value


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pathway_tpu_torch.cli",
        description="pathway_tpu_torch command line.")
    sub = parser.add_subparsers(dest="command", metavar="COMMAND")
    sub.required = True

    def command(name: str, fn, help: str, doc: str | None = None, **kw):
        p = sub.add_parser(name, help=help, description=doc or help, **kw)
        p.set_defaults(fn=fn)
        return p

    p = command(
        "spawn", spawn, "Launch PROGRAM with the worker environment set.",
        "Launch PROGRAM with the worker environment set (reference "
        "cli.py:53). Its own pw.run() chooses the device.")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="worker threads per process")
    p.add_argument("-n", "--processes", type=int, default=1,
                   help="number of processes")
    p.add_argument("--first-port", type=int, default=10000,
                   help="cluster port base")
    p.add_argument("--record", action="store_true",
                   help="record input streams for later replay")
    p.add_argument("--record-path", type=str, default="record",
                   help="where recorded input lands")
    p.add_argument("-a", "--addresses", type=str, default=None,
                   help="multi-host address book: comma-separated "
                        "host[:port], one per process (timely hostfile "
                        "analog)")
    p.add_argument("-p", "--process", dest="local_ids", type=int,
                   action="append", default=[],
                   help="launch only these process ids on this machine "
                        "(repeatable; default: all — use with --addresses "
                        "when the ensemble spans machines)")
    p.add_argument("--supervise", action="store_true",
                   help="self-healing mode: on any worker death, tear down "
                        "the survivors cooperatively and restart the "
                        "ensemble from the last common snapshot (jittered "
                        "exponential backoff, crash-loop circuit breaker — "
                        "see PATHWAY_SUPERVISE_MAX_RESTARTS and friends)")
    p.add_argument("--elastic", action="store_true",
                   help="elastic boot: if the persisted state was written by "
                        "a different worker count, worker 0 runs the state "
                        "resharder (rescale) in-process before the engine "
                        "mounts it (sets PATHWAY_ELASTIC=1)")
    p.add_argument("--autoscale", dest="autoscale_range", type=str,
                   default=None, metavar="MIN..MAX",
                   help="closed-loop autoscaling between MIN and MAX workers")
    p.add_argument("--store", dest="autoscale_store", type=str, default=None,
                   help="persistence root the program writes (the path given "
                        "to pw.persistence.Backend.filesystem) — the state "
                        "--autoscale reshards between worker counts and "
                        "--upgrade-to migrates between graph versions")
    p.add_argument("--upgrade-to", dest="upgrade_to", type=str, default=None,
                   metavar="NEW_SCRIPT",
                   help="zero-downtime code upgrade before launching")
    p.add_argument("--allow-drop", action="store_true",
                   help="with --upgrade-to: accept dropping stateful "
                        "operators that have no match in the new script")
    p.add_argument("program", nargs=argparse.REMAINDER,
                   help="the program and its arguments")

    p = command("replay", replay,
                "Re-run PROGRAM against recorded input (reference cli.py:194).")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-n", "--processes", type=int, default=1)
    p.add_argument("--record-path", type=str, default="record")
    p.add_argument("--mode", choices=["batch", "speedrun"], default="batch",
                   help="replay all at once (batch) or with original pacing")
    p.add_argument("--continue", dest="continue_after_replay",
                   action="store_true",
                   help="keep consuming live data after the replay finishes")
    p.add_argument("program", nargs=argparse.REMAINDER,
                   help="the program and its arguments")

    p = command(
        "rescale", rescale, "Repartition persisted cluster state to --to workers.",
        "Repartition persisted cluster state to --to workers. STORE is the "
        "persistence root (the path given to pw.persistence.Backend."
        "filesystem, or an s3://bucket/prefix URI). The resharder splits "
        "every stateful operator's snapshot and every live input chunk by row "
        "key, writes a complete layout for the new worker count, and promotes "
        "it with one atomic cluster-marker rewrite — a crash mid-rescale "
        "leaves the old layout bootable.")
    p.add_argument("--to", dest="to_workers", type=int, required=True,
                   help="target worker count")
    p.add_argument("--backend", dest="backend_kind",
                   choices=["filesystem", "s3"], default="filesystem",
                   help="persistence backend kind holding the state")
    p.add_argument("--dry-run", action="store_true",
                   help="plan only: print the split/merge each stateful "
                        "operator would undergo and the input tail to "
                        "re-route, without staging or promoting anything")
    p.add_argument("store")

    p = command("upgrade", upgrade,
                "Migrate persisted state at STORE to the graph NEW_SCRIPT builds.")
    p.add_argument("args", nargs=argparse.REMAINDER)

    p = command(
        "top", top, "Live cluster dashboard over the /query signals endpoint.",
        "Live cluster dashboard over the /query signals endpoint. Shows "
        "per-worker tick rate, frontier lag, latency percentiles, comm queue "
        "depth + send MB/s, the current bottleneck operator, and firing SLO "
        "alerts. Point it at process 0 of a running pipeline: top --port "
        "20000.")
    _monitor_options(p, "query")
    p.add_argument("-i", "--interval", type=float, default=1.0,
                   help="refresh interval in seconds")
    p.add_argument("--frames", type=int, default=0,
                   help="render N frames then exit (0 = run until ^C; "
                        "used by tests/smokes)")
    p.add_argument("--no-clear", action="store_true",
                   help="append frames instead of repainting (for logs/pipes)")

    p = command(
        "critpath", critpath,
        "Commit-wave critical-path report over the /query endpoint.",
        "Commit-wave critical-path report over the /query endpoint. Fetches "
        "the merged latency-lineage document (process 0 of a running "
        "pipeline) and prints the top-K slowest commit waves with the holding "
        "worker — the last frontier to arrive — and the per-stage split of "
        "each wave's wall time: critpath --port 20000.")
    _monitor_options(p, "query")
    p.add_argument("-k", "--top-k", dest="top_k", type=int, default=10,
                   help="slowest waves to report")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="dump the raw merged waves document instead")

    p = command(
        "profile", profile,
        "Cluster-merged flamegraph from the continuous profiler.",
        "Cluster-merged flamegraph from the continuous profiler. Fetches the "
        "always-on sampling profiler's merged collapsed-stack table from "
        "/profile on process 0 of a running pipeline (every sample tagged "
        "with the executing operator, joining against /attribution) and "
        "renders a self-time table, collapsed-stack text, or speedscope "
        "JSON: profile --port 20000.")
    _monitor_options(p, "profile")
    p.add_argument("--speedscope", dest="as_speedscope", action="store_true",
                   help="emit speedscope JSON (paste into speedscope.app)")
    p.add_argument("--collapsed", dest="as_collapsed", action="store_true",
                   help="emit collapsed-stack text (flamegraph.pl / inferno)")
    p.add_argument("--top", dest="top_n", type=int, default=15,
                   help="frames in the default self-time table")
    p.add_argument("--mode", choices=["wall", "cpu"], default="wall",
                   help="wall samples or CPU-time-weighted samples")
    p.add_argument("--local", dest="local_only", action="store_true",
                   help="this process only (skip the cluster merge)")
    p.add_argument("--heap", dest="as_heap", action="store_true",
                   help="on-demand tracemalloc heap snapshot instead")
    p.add_argument("-o", "--output", type=str, default=None,
                   help="write to a file instead of stdout")

    p = command(
        "dlq", dlq,
        "Inspect the sink dead-letter queue.",
        "Inspect the sink dead-letter queue (poison rows the delivery layer "
        "refused to drop silently). Default directory: PATHWAY_SINK_DLQ_DIR "
        "or ./pathway-dlq.")
    p.add_argument("dlq_dir", nargs="?", default=None)
    p.add_argument("--sink", dest="sink_name", type=str, default=None,
                   help="only this sink's entries")
    p.add_argument("--tail", dest="tail_n", type=int, default=5,
                   help="newest entries to print per sink (0 = summary only)")

    p = command(
        "lint", lint,
        "Statically analyze pipeline scripts without running them.",
        "Statically analyze pipeline scripts without running them. Each "
        "TARGET (a script, or a directory expanded to every .py beneath it) "
        "executes in build-only mode — pw.run() is stubbed, nothing flows — "
        "and the compiled dataflow graph, lowered on --device, is checked for "
        "unbounded state growth, replay-nondeterministic UDFs, per-row "
        "dispatch tax, fusion opportunities, shard skew and sink "
        "misconfiguration, with a stable structural fingerprint per operator. "
        "Suppress a finding inline with '# pathway: ignore[<id>]'. Exit "
        "codes: 0 clean (or info only), 1 warnings, 2 errors, 3 a script "
        "crashed while building (thresholded by --fail-on).")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="machine-readable JSON report (one document per script)")
    p.add_argument("--workers", dest="n_workers", type=int, default=None,
                   help="worker count the deployment targets (shard-skew "
                        "modeling; default PATHWAY_LINT_WORKERS or the "
                        "current config)")
    p.add_argument("--fail-on", choices=["error", "warning", "never"],
                   default="warning",
                   help="severity threshold for a nonzero exit code "
                        "(default: warning)")
    p.add_argument("--no-fingerprints", action="store_true",
                   help="omit the per-operator fingerprint table")
    p.add_argument("--device", type=str, default="cuda",
                   help="device the scripts' graphs are lowered on "
                        "(default: cuda)")
    p.add_argument("targets", nargs="+", type=_existing_path)

    p = command("trace", None, "Distributed-trace tooling (PATHWAY_TRACE_FILE).")
    tsub = p.add_subparsers(dest="trace_command", metavar="COMMAND")
    tsub.required = True
    m = tsub.add_parser(
        "merge", help="Merge per-process trace parts into one cluster timeline.",
        description="Merge per-process trace parts into one cluster timeline. "
        "BASE is the PATHWAY_TRACE_FILE value of the run; the per-process "
        "BASE.p<N> parts (or BASE itself for a single-process run) are "
        "assembled into one clock-aligned Chrome/Perfetto JSON.")
    m.set_defaults(fn=trace_merge)
    m.add_argument("base")
    m.add_argument("-o", "--output", type=str, default=None,
                   help="merged timeline path (default: <base>.merged.json)")
    m.add_argument("--allow-mixed-runs", action="store_true",
                   help="merge parts with different run ids anyway")
    return parser


def main(argv: list[str] | None = None) -> int:
    """Run one command; returns its exit code (2 for a usage error)."""
    try:
        args = _parser().parse_args(argv)
    except SystemExit as e:  # usage error (2) or --help (0)
        return e.code if isinstance(e.code, int) else 2
    try:
        return args.fn(args)
    except CommandError as e:
        _echo(f"Error: {e}", err=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
