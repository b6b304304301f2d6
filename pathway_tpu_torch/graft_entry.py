"""Entry points: the flagship forward, and the multi-rank dry run.

Port of ``__graft_entry__.py``:

- :func:`entry` returns the forward step of the flagship model (the encoder behind the RAG
  pipeline) and its example arguments, on ``device``;
- :func:`dryrun_multichip` runs, on an initialised ``torch.distributed`` group of ``n`` ranks,
  ONE full distributed training step on a (data, model) mesh (the batch and the index split
  over ``data``, the encoder's weights over ``model``, the search's all-gather merge), the
  long-context embedding with ring attention over a ``seq`` mesh of all ``n`` ranks, and on rank
  0 the flagship dataflow's parity legs: a groupby + join at ``max(2, min(8, n))`` worker threads
  over ``LocalComm`` and over ``MeshComm`` against one worker, and its recovery from a sharded
  snapshot against a clean run.

Run both as ``python -m pathway_tpu_torch.graft_entry [--device cpu]``: the process group comes
from the ``PATHWAY_*`` environment (``parallel/distributed.py::init_from_env``), so ``spawn -n
M`` of the command line runs the dry run over M ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
from collections import Counter

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["entry", "dryrun_multichip"]


def entry(device: str | torch.device = "cuda"):
    """(fn, args): ``fn(*args)`` is the flagship encoder's forward over a batch of 8 x 64
    tokens (numpy's seed 0), with the weights of :func:`init_params` of seed 0, on ``device``."""
    from .models.embedder import EmbedderConfig, embed_tokens, init_params

    dev = resolve_device(device)
    cfg = EmbedderConfig(vocab_size=4096, dim=128, n_layers=2, n_heads=4, max_len=64)
    params = init_params(cfg, 0, device=dev)
    fn = functools.partial(embed_tokens, cfg=cfg)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (8, 64)), dtype=torch.int32,
                             device=dev)
    return fn, (params, tokens)


@contextlib.contextmanager
def _one_process(threads: int):
    """``PATHWAY_THREADS=threads`` and a single process for the block (a dry run under ``spawn
    -n M`` has ``PATHWAY_PROCESSES=M`` in its environment)."""
    saved = {k: os.environ.get(k) for k in ("PATHWAY_THREADS", "PATHWAY_PROCESSES")}
    os.environ.update(PATHWAY_THREADS=str(threads), PATHWAY_PROCESSES="1")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sharded_dataflow_parity(n_workers: int, device: torch.device) -> tuple[int, int]:
    """Run the flagship *dataflow* (groupby + join over the incremental engine) at one worker
    and at ``n_workers`` threads over LocalComm, then over MeshComm (the dense columns bucketed on
    ``device``), and assert the final row multisets match. Returns (workers used, result rows)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.testing import T, _norm

    def run_once(workers: int) -> Counter:
        G.clear()
        lines = ["k | v"]
        for i in range(64):
            lines.append(f"g{i % 7} | {i}")
        t = T("\n".join(lines))
        counts = t.groupby(pw.this.k).reduce(
            pw.this.k, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count()
        )
        names = T("\n".join(["k | label"] + [f"g{i} | L{i}" for i in range(7)]))
        res = counts.join(names, counts.k == names.k).select(
            pw.right.label, s=pw.left.s, c=pw.left.c
        )
        acc: Counter = Counter()
        cols = res.column_names()
        pw.io.subscribe(
            res,
            on_change=lambda key, row, time, is_addition: acc.update(
                {tuple(_norm(row[c]) for c in cols): 1 if is_addition else -1}
            ),
        )
        try:
            with _one_process(workers):
                pw.run(device=device)
        finally:
            G.clear()
        assert all(v >= 0 for v in acc.values()), (
            f"spurious retractions (negative final multiplicity): {acc}"
        )
        return +acc

    workers = max(2, min(8, n_workers))  # engine worker cap (config.rs:7-11)
    single = run_once(1)
    sharded = run_once(workers)
    assert sharded == single, (
        f"sharded dataflow diverged at {workers} workers:\n"
        f"  missing={single - sharded}\n  extra={sharded - single}"
    )
    assert sum(single.values()) == 7
    prev_mesh = os.environ.get("PATHWAY_MESH_EXCHANGE")
    os.environ["PATHWAY_MESH_EXCHANGE"] = "1"
    try:
        meshed = run_once(workers)
    finally:
        if prev_mesh is None:
            os.environ.pop("PATHWAY_MESH_EXCHANGE", None)
        else:
            os.environ["PATHWAY_MESH_EXCHANGE"] = prev_mesh
    assert meshed == single, (
        f"mesh-exchange dataflow diverged at {workers} workers:\n"
        f"  missing={single - meshed}\n  extra={meshed - single}"
    )
    return workers, sum(single.values())


def _sharded_recovery_parity(n_workers: int, device: torch.device) -> tuple[int, int]:
    """Run the flagship dataflow PERSISTED at ``n_workers`` workers, stop mid-stream, restart
    from the sharded snapshot with the remainder of the input, and assert the post-recovery
    finals equal a clean unpersisted run of the whole stream. Returns (workers used, distinct
    result rows)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.persistence import Backend, Config, MemoryBackend

    workers = max(2, min(8, n_workers))
    words = [f"w{i % 5}" for i in range(40)]
    store = f"dryrun-recovery-{os.getpid()}"

    class Emitter(pw.io.python.ConnectorSubject):
        def __init__(self, upto: int):
            super().__init__()
            self.upto = upto

        def run(self):
            for w in words[: self.upto]:
                self.next(word=w)
                self.commit()

    def run_counts(upto: int, cfg, n: int) -> dict:
        G.clear()
        t = pw.io.python.read(
            Emitter(upto),
            schema=pw.schema_from_types(word=str),
            name="dryrun-recovery-words",
        )
        counts = t.groupby(pw.this.word).reduce(
            pw.this.word, c=pw.reducers.count()
        )
        finals: dict = {}
        pw.io.subscribe(
            counts,
            on_change=lambda key, row, time, is_addition: (
                finals.__setitem__(row["word"], int(row["c"]))
                if is_addition
                else None
            ),
        )
        try:
            with _one_process(n):
                pw.run(persistence_config=cfg, device=device)
        finally:
            G.clear()
        return finals

    expected = run_counts(len(words), None, 1)
    assert expected == {f"w{i}": 8 for i in range(5)}
    MemoryBackend.drop(store)
    cfg = Config.simple_config(Backend.memory(store))
    partial = run_counts(24, cfg, workers)
    assert all(v <= expected[k] for k, v in partial.items())
    recovered = run_counts(len(words), cfg, workers)
    merged = {**partial, **recovered}
    assert merged == expected, (
        f"post-recovery divergence at {workers} workers:\n"
        f"  expected={expected}\n  partial={partial}\n"
        f"  after-recovery={recovered}"
    )
    MemoryBackend.drop(store)
    return workers, len(expected)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """The dry run over the ``n_devices`` ranks of the default process group (which must
    exist: ``parallel/distributed.py::init_from_env``), each rank on ``device``. Every rank runs
    the mesh step and the ring leg; rank 0 also runs the dataflow and recovery legs. Returns
    what it held, and prints it on rank 0."""
    import torch.distributed as dist

    from .models.embedder import EmbedderConfig, init_params
    from .models.pipeline import run_one_step
    from .models.ring_attention import embed_tokens_long
    from .parallel.mesh import data_model_mesh, make_mesh

    dev = resolve_device(device)
    mesh = data_model_mesh(n_devices, device=dev.type)
    loss, scores, ids = run_one_step(mesh=mesh, device=dev)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert scores.shape[1] >= 1 and ids.shape == scores.shape

    # sequence parallelism: long-context embedding with ring attention over all n ranks
    sp_mesh = make_mesh({"seq": n_devices}, device=dev.type)
    cfg = EmbedderConfig(vocab_size=512, dim=32, n_layers=1, n_heads=4, max_len=32,
                         dtype=torch.float32)
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 16 * n_devices)),
                             dtype=torch.int32)
    long_emb = embed_tokens_long(params, tokens, cfg, sp_mesh, "seq")
    assert torch.isfinite(long_emb).all()

    out = {"mesh": {"data": mesh.size(0), "model": mesh.size(1)}, "loss": loss,
           "topk_ids": ids[0].tolist(), "seq": tokens.shape[1]}
    if dist.get_rank() == 0:
        # the product: the incremental dataflow engine itself, sharded, and its recovery
        out["dataflow"] = _sharded_dataflow_parity(n_devices, dev)
        out["recovery"] = _sharded_recovery_parity(n_devices, dev)
        print(
            f"dryrun_multichip OK: mesh={out['mesh']} loss={loss:.4f} "
            f"topk_ids={out['topk_ids']} ring_attention seq={out['seq']} over {n_devices} "
            f"ranks | dataflow groupby+join parity at {out['dataflow'][0]} workers "
            f"({out['dataflow'][1]} rows, single-worker == sharded == mesh-exchange) | "
            f"snapshot recovery parity at {out['recovery'][0]} workers "
            f"({out['recovery'][1]} keys, mid-stream restart == clean run)",
            flush=True,
        )
    dist.barrier()
    return out


def main(argv: list[str] | None = None) -> int:
    import torch.distributed as dist

    from .parallel.distributed import init_from_env

    p = argparse.ArgumentParser(prog="python -m pathway_tpu_torch.graft_entry",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    init_from_env(device=dev.type)
    try:
        fn, args = entry(dev)
        with torch.no_grad():
            out = fn(*args)
        if dist.get_rank() == 0:
            print("entry OK:", tuple(out.shape), out.dtype, flush=True)
        dryrun_multichip(dist.get_world_size(), device=dev)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
