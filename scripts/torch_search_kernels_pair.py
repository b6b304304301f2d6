"""Hold and time the fused score + top-k kernel and the InfoNCE kernel of checkouts of
``pathway_tpu_torch`` on one card.

    python scripts/torch_search_kernels_pair.py [--paths] TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one). Every TREE runs in a process of its
own, in the order given, so that ``A B B A`` pairs two versions within one call on one card. A
process builds that tree's two kernels with ``nvcc`` (ptxas's report of each goes to standard
error: registers, shared memory, stack frame and spills), then:

- ``topk_scores`` at the retrieval shape, q=64 seeded queries near rows of a seeded index of
  1,048,576 unit rows of 384 (4,096 of them duplicated, so that scores tie exactly), k=10, cos:
  with a valid mask that drops a tenth of the rows (the RAG search's call) and without one (the
  training step's); and ``torch.topk`` of the bf16 product on the same inputs, the library call
  beside it;
- ``infonce`` at the training step's B=256 on seeded logits of its scale, and an empty kernel on
  the same launch where the tree has one (``infonce_empty``: the launch's own cost).

With ``--paths`` each process then also runs that tree's ``chip_smoke.py`` RAG path and training
step at full width (``run_main_path`` and ``run_training`` with their defaults: 8 searches of 64
text queries at k=10 over 1,048,576 rows, and 10 timed steps at B=256) and adds the search p50 and
the step's mean time; their logs go to standard error.

For each: the outputs held against the plain version on the same inputs (the scorer's scores
within one bf16 ulp of the dot, ids equal where the scores are clear of their neighbours, ties
lower row first; InfoNCE's loss and gradient within 1e-5), the SHA-256 of the outputs' bytes
(equal digests from two trees: equal bits), the median of 5 rounds of CUDA-event times around
back-to-back calls (what a caller waits, the host's wrapper included), and the profiler's device
time a call by kernel name (both passes of the scorer). Every process prints one JSON line; the
card's name and power limit come first.
"""

from __future__ import annotations

import hashlib
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROUNDS = 5
Q, N, D, K = 64, 1 << 20, 384, 10
B = 256
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(torch, fn, calls: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(torch, fn, calls: int, sessions: int = 3) -> dict | None:
    """The device's work a call by name (ms), from the profiler over ``calls`` calls after a
    warm-up step in the same session (the tracer misses a session's first launches); None when
    the tracer recorded nothing in ``sessions`` sessions."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts,
                                    schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                                     active=1)) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            by_name = {e.key[:60]: e.self_device_time_total / 1e3 / calls for e in events}
            return {"total": sum(by_name.values()), "by_name": by_name,
                    "recorded": {e.key[:60]: e.count for e in events}}
    return None


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def knn_inputs(torch, device):
    """``chip_smoke.py``'s ``knn_inputs`` at the retrieval shape."""
    gen = torch.Generator(device=device).manual_seed(13)
    index = torch.randn((N, D), generator=gen, device=device)
    index /= index.norm(dim=1, keepdim=True)
    dup = torch.arange(0, 4096, device=device)
    index[N // 2 + dup] = index[dup]
    valid = torch.rand((N,), generator=gen, device=device) > 0.1
    valid[dup] = True
    valid[N // 2 + dup] = True
    pick = dup[torch.randint(0, len(dup), (Q,), generator=gen, device=device)]
    queries = index[pick] + 0.05 * torch.randn((Q, D), generator=gen, device=device)
    return queries.contiguous(), index, valid


def held(torch, s_k, i_k, s_p, i_p) -> int:
    """The kernel's [q, k] against the plain version's [q, k + 1] (cos): returns the ties seen."""
    ulp = torch.exp2(torch.floor(torch.log2(s_p.abs().clamp_min(2.0 ** -126))) - 7)
    k = s_k.shape[1]
    if ((s_k - s_p[:, :k]).abs() > ulp[:, :k]).any():
        raise AssertionError("knn_topk: scores differ from the plain version by more than 1 ulp")
    gap_prev = torch.full_like(s_p[:, :k], math.inf)
    gap_prev[:, 1:] = s_p[:, : k - 1] - s_p[:, 1:k]
    clear = (gap_prev > ulp[:, :k]) & (s_p[:, :k] - s_p[:, 1 : k + 1] > ulp[:, :k])
    if (clear & (i_k != i_p[:, :k])).any():
        raise AssertionError("knn_topk: ids differ from the plain version where scores are clear")
    ties = s_k[:, 1:] == s_k[:, :-1]
    if (ties & (i_k[:, 1:] <= i_k[:, :-1])).any():
        raise AssertionError("knn_topk: equal scores not in lower-id-first order")
    return int(ties.sum().item())


def scorer(torch, knn) -> dict:
    dev = torch.device("cuda")
    queries, index, valid = knn_inputs(torch, dev)
    out = {}
    for label, mask in (("masked", valid), ("unmasked", None)):
        s_k, i_k = knn.topk_scores(queries, index, K, "cos", valid=mask)
        s_p, i_p = knn.topk_scores_plain(queries, index, K + 1, "cos", valid=mask)
        torch.cuda.synchronize()
        row = {"ties": held(torch, s_k, i_k, s_p, i_p), "sha256": digest(s_k, i_k),
               "ms": cuda_ms(torch, lambda: knn.topk_scores(queries, index, K, "cos",
                                                           valid=mask), 10),
               "device": device_ms(torch, lambda: knn.topk_scores(queries, index, K, "cos",
                                                                 valid=mask), 10)}
        del s_p, i_p
        n_bytes = Q * D * 4 + N * D * 4 + (0 if mask is None else N) + Q * K * (4 + 8)
        row["bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
        if hasattr(knn, "STREAM_MAX_K"):  # a tree with two routes names the one it takes
            row["route"] = knn.plan(Q, N, D, K, torch.cuda.get_device_properties(dev)
                                    .multi_processor_count).route
        out[label] = row
    qb, ib = queries.to(torch.bfloat16), index.to(torch.bfloat16)
    out["library_ms"] = cuda_ms(torch, lambda: torch.topk(qb @ ib.T, K), 3)
    out["shape"] = f"q={Q} n={N} d={D} k={K} cos"
    return out


def contrastive(torch, nce) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    ea = torch.nn.functional.normalize(torch.randn((B, 384), generator=gen, device=dev), dim=1)
    eb = torch.nn.functional.normalize(
        ea + 0.5 * torch.randn((B, 384), generator=gen, device=dev), dim=1)
    logits = ((ea @ eb.T) / 0.07).requires_grad_()
    loss = nce.infonce(logits)
    (grad,) = torch.autograd.grad(loss, logits)
    want = nce.infonce_plain(logits)
    (want_grad,) = torch.autograd.grad(want, logits)
    torch.cuda.synchronize()
    l_err = abs(loss.item() - want.item())
    g_err = (grad - want_grad).abs()
    if l_err > 1e-5 * max(1.0, abs(want.item())) or (
            g_err > 1e-5 * (1.0 / B + want_grad.abs())).any():
        raise AssertionError(f"infonce: loss err {l_err}, grad err {g_err.max().item()}")
    plain = logits.detach()
    row = {"loss_err": l_err, "grad_err": g_err.max().item(), "sha256": digest(loss, grad),
           "ms": cuda_ms(torch, lambda: nce.infonce(plain), 50),
           "device": device_ms(torch, lambda: nce.infonce(plain), 50),
           "bound_ms": (2 * B * B * 4 + 4) / HBM_BYTES_PER_S * 1e3, "shape": f"B={B}"}
    empty = getattr(nce, "infonce_empty", None)
    if empty is not None:
        row["empty_ms"] = cuda_ms(torch, lambda: empty(B, dev), 50)
        row["empty_device"] = device_ms(torch, lambda: empty(B, dev), 50)
    return row


def end_to_end(tree: str) -> dict:
    """The tree's RAG search p50 and training step, by its own ``chip_smoke.py``."""
    import contextlib
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(tree) / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda")
    with contextlib.redirect_stdout(sys.stderr):
        path = cs.run_main_path(dev, n_chunks=16384, n_rows=1 << 20, tick=1024, n_queries=64,
                                n_searches=8, k=10)
        torch.cuda.empty_cache()
        train = cs.run_training(dev)
    torch.cuda.empty_cache()
    return {"search_p50_ms": path["search_p50_ms"], "search_ms": path["search_ms"],
            "step_ms": train["step_ms"]}


def child(tree: str, paths: bool) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from pathway_tpu_torch import _kernels
    from pathway_tpu_torch.ops import infonce as nce
    from pathway_tpu_torch.ops import knn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    logs = _kernels._build([n for n in ("knn_topk", "infonce")
                            if not _kernels._target(n).exists()])
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "stack")):
                print(f"{tree} {name}: {line.strip()}", file=sys.stderr)
    result = {"tree": tree, "knn_topk": scorer(torch, knn), "infonce": contrastive(torch, nce)}
    if paths:
        torch.cuda.empty_cache()
        result["paths"] = end_to_end(tree)
    print(json.dumps(result), flush=True)


def main(trees: list[str], paths: bool) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--child", tree] + ["--paths"] * paths,
                       check=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3:] == ["--paths"])
        sys.exit(0)
    args = [a for a in sys.argv[1:] if a != "--paths"]
    if not args:
        sys.exit(__doc__)
    sys.exit(main(args, "--paths" in sys.argv[1:]))
