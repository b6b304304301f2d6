"""One rank of the port's multi-process tests, run without JAX: ring attention, long-context
embedding, the sharded KNN search, the engine's bucketed all-to-all, the training step on a
(data, model) mesh and the dry run of ``graft_entry`` over a gloo group of CPU processes.

The tests spawn one process per rank with :class:`RankRun`; each process runs every case of
its suite on the inputs the test wrote (made with numpy from a seed, weights from the JAX
package) and writes its results to an ``.npz`` for the test to hold against the JAX package.
A rank process blocks ``jax`` and ``pathway_tpu`` before it imports the port, and reports the
modules of either that it finds loaded at its end (none are expected).

    python tests/torch_dist_child.py SUITE WORLD RANK WORKDIR
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: seconds a rank may take before the test fails it (a hung collective must not hang the suite)
RANK_TIMEOUT = 120


class RankRun:
    """``world`` rank processes of ``suite``, started at once on ``inputs`` (written to
    ``workdir``), so that the caller can compute its references while they run."""

    def __init__(self, suite: str, world: int, workdir: Path, inputs: dict):
        workdir.mkdir(parents=True, exist_ok=True)
        with open(workdir / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
        self.world, self.workdir = world, workdir
        self.procs = [
            subprocess.Popen(
                [sys.executable, __file__, suite, str(world), str(rank), str(workdir)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in range(world)
        ]

    def results(self) -> list[dict]:
        """Each rank's results (a dict of arrays), once all have ended. Raises with the ranks'
        output if one fails or takes longer than ``RANK_TIMEOUT`` seconds."""
        logs, failed = [], False
        for proc in self.procs:
            try:
                logs.append(proc.communicate(timeout=RANK_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                for p in self.procs:
                    p.kill()
                logs.append(proc.communicate()[0] + f"\n(timed out after {RANK_TIMEOUT} s)")
            failed |= proc.returncode != 0
        if failed:
            raise AssertionError("a rank failed:\n" + "\n---\n".join(x[-3000:] for x in logs))
        return [dict(np.load(self.workdir / f"rank{r}.npz")) for r in range(self.world)]


def _block_jax_and_reference() -> None:
    import importlib.abc

    sys.modules["jax"] = None

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "pathway_tpu" or name.startswith("pathway_tpu."):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())


def _ring_suite(inp: dict, mesh, rank: int, world: int) -> dict:
    import torch

    from pathway_tpu_torch.models.embedder import EmbedderConfig, params_from_jax
    from pathway_tpu_torch.models.ring_attention import embed_tokens_long, ring_attention

    out = {}
    q, k, v, mask = (torch.from_numpy(inp["attn"][n]) for n in ("q", "k", "v", "mask"))
    s = q.shape[1] // world
    part = slice(rank * s, (rank + 1) * s)
    out["ring"] = ring_attention(q[:, part], k[:, part], v[:, part], mask[:, part], mesh,
                                 "data", inp["attn"]["scale"]).numpy()
    for name, case in inp["embed"].items():
        cfg = EmbedderConfig(**case["cfg"], dtype=getattr(torch, case["dtype"]))
        params = params_from_jax(case["params"], device="cpu")
        out[f"embed_{name}"] = embed_tokens_long(
            params, torch.from_numpy(case["tokens"]), cfg, mesh, "data").numpy()
    return out


def _knn_suite(inp: dict, mesh, rank: int, world: int) -> dict:
    import torch

    from pathway_tpu_torch.ops.knn import ShardedKnnIndex, sharded_knn_search
    from pathway_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for name, case in inp["index"].items():
        sharded = ShardedKnnIndex(case["dim"], capacity=case["capacity"], metric=case["metric"],
                                  mesh=mesh, device="cpu")
        single = ShardedKnnIndex(case["dim"], capacity=case["capacity"], metric=case["metric"],
                                 device="cpu")
        for batch in case["batches"]:
            sharded.add(batch)
            single.add(batch)
        out[f"{name}_s"], out[f"{name}_i"] = sharded.query(case["queries"], case["k"])
        out[f"{name}_single_s"], out[f"{name}_single_i"] = single.query(case["queries"],
                                                                         case["k"])
        if name == "match":  # k = 0: [q, 0] on every rank, with no collective
            out["match_k0_s"], out["match_k0_i"] = sharded.query(case["queries"], 0)
    for name, call in (
        ("k_over_shard", lambda: sharded_knn_search(
            mesh, "data", torch.zeros((1, 8)), torch.zeros((4, 8)), 5)),
        ("uneven_capacity", lambda: ShardedKnnIndex(8, capacity=4 * world + 1, mesh=mesh,
                                                    device="cpu")),
        ("axes_not_covering", lambda: make_mesh({"data": world + 1}, device="cpu")),
    ):
        try:
            call()
            out[f"{name}_raised"] = np.array(False)
        except ValueError:
            out[f"{name}_raised"] = np.array(True)
    return out


def _exchange_suite(inp: dict, mesh, rank: int, world: int) -> dict:
    """Each case's rank form: this rank's block of the global rows, bucketed and swapped with
    ``all_to_all_single``."""
    from pathway_tpu_torch.parallel.exchange import bucketed_all_to_all

    out = {}
    for name, (values, dest, cap_out) in inp["cases"].items():
        cap_in = len(dest) // world
        mine = slice(rank * cap_in, (rank + 1) * cap_in)
        words, valid = bucketed_all_to_all(values[mine], dest[mine], world, cap_out,
                                           group=mesh.get_group("data"), device="cpu")
        out[f"{name}_out"], out[f"{name}_valid"] = words.numpy(), valid.numpy()
    return out


def _pipeline_suite(inp: dict, mesh, rank: int, world: int) -> dict:
    """Each case's step on ``data_model_mesh(world)``: the rank's shard of the JAX package's
    weights and its rows of the batch and the index; the results gathered whole."""
    import torch
    import torch.distributed as dist

    from pathway_tpu_torch.models import pipeline as P
    from pathway_tpu_torch.models.embedder import EmbedderConfig, params_from_jax
    from pathway_tpu_torch.parallel.mesh import data_model_mesh

    dm = data_model_mesh(world, device="cpu")
    ax = P._Axes(dm)
    out = {"mesh": np.array([ax.n_data, ax.n_model, ax.d, ax.m])}
    for name, case in inp["cases"].items():
        cfg = EmbedderConfig(**case["cfg"])
        full = params_from_jax(case["params"], device="cpu")
        shard = P.param_shardings(dm, full, cfg)
        out[f"{name}_qkv_shape"] = np.array(shard["layers"][0]["qkv"].shape)
        out[f"{name}_roundtrip"] = np.array(all(
            torch.equal(a, b) for a, b in zip(P._leaves(P.gather_params(dm, shard)),
                                              P._leaves(full))))
        n = len(case["tokens"]) // ax.n_data
        mine = slice(ax.d * n, (ax.d + 1) * n)
        index = torch.zeros((case["capacity"] // ax.n_data, cfg.dim))
        step = P.make_step(cfg, k=case["k"], lr=case["lr"], mesh=dm, device="cpu")
        new, idx, loss, s, i = step(shard, torch.from_numpy(case["tokens"][mine]),
                                    torch.from_numpy(case["tokens_aug"][mine]), index,
                                    case["insert_at"], torch.from_numpy(case["queries"]))
        out[f"{name}_in_place"] = np.array(idx is index)
        for j, leaf in enumerate(P._leaves(P.gather_params(dm, new))):
            out[f"{name}_p{j}"] = leaf.numpy()
        parts = [torch.empty_like(idx) for _ in range(ax.n_data)]
        dist.all_gather(parts, idx, group=ax.data)
        out[f"{name}_index"] = torch.cat(parts).numpy()
        out[f"{name}_loss"] = np.array(float(loss))
        out[f"{name}_scores"], out[f"{name}_ids"] = s.numpy(), i.numpy()
    try:
        P.make_step(EmbedderConfig(vocab_size=64, dim=48, n_layers=1, n_heads=3, max_len=8),
                    mesh=dm, device="cpu")
        out["odd_heads_refused"] = np.array("")
    except ValueError as e:
        out["odd_heads_refused"] = np.array(str(e))
    return out


def _dryrun_suite(inp: dict, mesh, rank: int, world: int) -> dict:
    from pathway_tpu_torch.graft_entry import dryrun_multichip

    got = dryrun_multichip(world, device="cpu")
    out = {"loss": np.array(got["loss"]), "topk_ids": np.array(got["topk_ids"]),
           "mesh": np.array([got["mesh"]["data"], got["mesh"]["model"]])}
    if rank == 0:
        out["dataflow"], out["recovery"] = np.array(got["dataflow"]), np.array(got["recovery"])
    return out


def main() -> None:
    suite, world, rank, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    _block_jax_and_reference()
    import torch
    import torch.distributed as dist

    from pathway_tpu_torch.parallel.distributed import init_from_env
    from pathway_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    if world == 1:
        init_from_env(device="cpu")  # no PATHWAY_* environment: a group of one, in memory
    else:
        dist.init_process_group("gloo", init_method=f"file://{workdir / 'store'}", rank=rank,
                                world_size=world)
    mesh = make_mesh({"data": world}, device="cpu")
    with open(workdir / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    suites = {"ring": _ring_suite, "knn": _knn_suite, "exchange": _exchange_suite,
              "pipeline": _pipeline_suite, "dryrun": _dryrun_suite}
    out = suites[suite](inp, mesh, rank, world)
    loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
        m.startswith("jax") or m == "pathway_tpu" or m.startswith("pathway_tpu.")))
    out["loaded_reference_modules"] = np.array(loaded, dtype=str)
    np.savez(workdir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
