"""Time the sharded search's top-k merge of two checkouts of ``pathway_tpu_torch`` on one card.

    python scripts/torch_merge_pair.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one). Every TREE runs in a process of its
own, in the order given, so that ``A B B A`` pairs two versions within one call on one card. For
q=64 and k=10, at m=10 (world size 1) and m=80 (8 shards, synthetic all-gather buffers on the one
card), a process times:

- ``kernel``: ``topk_merge`` on the gathered [q, m] rows, the merge kernel alone;
- ``path``: what that tree's ``sharded_knn_search`` launches after its local top k: where the tree
  has ``topk_merge_shards``, that one call on the [P, q, k] buffers; else the id offset add, the
  two shard-major reshape copies (P > 1) and ``topk_merge``;
- ``torch.topk`` on the same [q, m] scores (a yardstick: its tie order is not ``lax.top_k``'s).

Each is timed two ways: by CUDA events around 50 back-to-back calls, median of 5 rounds (what a
caller waits a call, the host's wrapper and launches included), and by the profiler (the device
time of one call: each kernel's mean time times its launches a call). Every process prints one
JSON line; the card's name and power limit come first.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

Q, K, CALLS, ROUNDS = 64, 10, 50, 5
ROWS_PER_SHARD = 1 << 17


def cuda_ms(fn) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def device_ms(fn) -> tuple[float | None, dict]:
    """The device time of one call from the profiler (one warm-up call, then CALLS recorded), and
    the launches it recorded of each kernel: a kernel's mean time counts once for each launch a
    call makes, so a launch the tracer drops does not lower the time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts,
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1)) as p:
        fn()
        torch.cuda.synchronize()
        p.step()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in p.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]  # the step's span, not a kernel
    counts = {e.key[:60]: e.count for e in kernels}
    if not kernels:
        return None, counts
    per_call = sum(e.self_device_time_total / e.count * max(1, round(e.count / CALLS))
                   for e in kernels)
    return per_call / 1e3, counts


def child(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from pathway_tpu_torch.ops import knn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    values = torch.tensor([0.5, 0.25, 0.0, -0.0, -0.25], device=dev)
    shards_entry = getattr(knn, "topk_merge_shards", None)
    out = {"tree": tree, "module": knn.__file__, "shards_entry": shards_entry is not None}
    for P in (1, 8):
        s = values[torch.randint(0, len(values), (P, Q, K), generator=gen, device=dev)]
        s[torch.rand((P, Q, K), generator=gen, device=dev) < 0.1] = -math.inf
        s = s.sort(dim=2, descending=True).values
        local = torch.randint(0, ROWS_PER_SHARD, (P, Q, K), generator=gen, device=dev)
        shift = torch.arange(P, device=dev).view(P, 1, 1) * ROWS_PER_SHARD
        flat_s = s.transpose(0, 1).reshape(Q, P * K)
        flat_i = (local + shift).transpose(0, 1).reshape(Q, P * K)
        want = knn.topk_merge_plain(flat_s, flat_i, K)
        got = knn.topk_merge(flat_s, flat_i, K)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{tree}: topk_merge at m={P * K} differs from its plain version")

        if shards_entry is not None:
            def path():
                return shards_entry(s, local, K, ROWS_PER_SHARD)

            if not all(torch.equal(g, w) for g, w in zip(path(), want)):
                raise AssertionError(f"{tree}: topk_merge_shards at m={P * K} differs")
        else:
            def path():  # this tree's sharded_knn_search around its all-gathers, as rank 0
                local[0] + 0 * ROWS_PER_SHARD  # the offset add, before the gather
                all_s = s.view(P, Q, K).transpose(0, 1).reshape(Q, P * K)
                all_i = local.view(P, Q, K).transpose(0, 1).reshape(Q, P * K)
                return knn.topk_merge(all_s, all_i, K)
        case = {}
        for name, fn in (("kernel", lambda: knn.topk_merge(flat_s, flat_i, K)), ("path", path),
                         ("torch_topk", lambda: torch.topk(flat_s, K, dim=1))):
            dms, counts = device_ms(fn)
            case[name] = {"ms": cuda_ms(fn), "device_ms": dms, "launches_recorded": counts}
        out[f"m={P * K}"] = case
    print(json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        child(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    for tree in argv:
        subprocess.run([sys.executable, __file__, "--child", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
