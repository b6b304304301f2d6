"""Hold and time the record exchange's bucketing kernel and the expression machine of checkouts of
``pathway_tpu_torch`` on one card.

    python scripts/torch_engine_kernels_pair.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one). Every TREE runs in a process of its
own, in the order given, so that ``A B B A`` pairs two versions within one call on one card. A
process builds that tree's two kernels with ``nvcc`` (ptxas's report of each goes to standard
error: registers, stack frame and spills), then:

- ``bucket_exchange`` on seeded words at the dense engine path's largest launch (n_src = 8,
  cap_in = 16,384, w = 14, n_dst = 8, cap_bucket = 16,384), with the sources' row counts ragged
  and 99% of the rows to destination 0, as a Capture's gather sends them; and at a wordcount
  launch shape (n_src = 8, cap_in = 2,048, w = 4, n_dst = 8, cap_bucket = 256: 1,250 rows a
  source spread over every destination);
- ``expression_vm`` on the Table API chain's program (``x * 2.0 - 1.0``, the filter, ``if_else``
  and ``cast``), lowered by that tree's own compiler from that tree's fused chain, over the seeded
  columns of one commit: 65,536 rows (one worker) and 32,768 (a worker's share at two); and on
  the lifted ``a * 3 + 7``, a member expression of the lifted pipeline, at 65,536 rows; and on
  two synthetic programs of 8 and 16 dependent integer adds at 65,536 rows, whose difference is
  the cost of 8 interpreted steps.

For each: the outputs held against the plain version on the same inputs, the SHA-256 of the
outputs' bytes (equal digests from two trees: equal bits), the median of 5 rounds of CUDA-event
times around back-to-back calls (what a caller waits, the host's wrapper included), and the
profiler's device time a call (every kernel and memset of the call, by name). For the machine,
also an empty kernel's time on the same grid, measured the same two ways (the launch's own
cost), where the tree has one. Every process prints one JSON line; the card's name and power
limit come first.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROUNDS = 5
EXCHANGE_SHAPES = {  # (n_src, cap_in, w, n_dst, cap_bucket, rows a source, share to 0)
    "dense_gather": (8, 16384, 14, 8, 16384, (16384, 9000, 8191, 8192, 12000, 16383, 4096, 11000),
                     0.99),
    "wordcount": (8, 2048, 4, 8, 256, (1250,) * 8, None),
}
VM_CASES = {  # label: (program, rows)
    "chain_one_worker": ("chain", 65536), "chain_two_workers": ("chain", 32768),
    "lifted_one_worker": ("lifted", 65536),
    "add_chain_8": ("add8", 65536), "add_chain_16": ("add16", 65536),
}


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
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def exchange(torch, ex) -> dict:
    out = {}
    for label, (n_src, cap_in, w, n_dst, cap_bucket, rows, to_zero) in EXCHANGE_SHAPES.items():
        gen = torch.Generator().manual_seed(cap_in + w)
        words = torch.randint(-2**31, 2**31 - 1, (n_src, cap_in, w), generator=gen,
                              dtype=torch.int64).to(torch.int32)
        dest = torch.randint(0, n_dst, (n_src, cap_in), generator=gen, dtype=torch.int32)
        if to_zero is not None:
            dest[torch.rand((n_src, cap_in), generator=gen) < to_zero] = 0
        for s, r in enumerate(rows):
            dest[s, r:] = -1
        words, dest = words.cuda(), dest.cuda()
        got = ex.bucket_exchange(words, dest, n_dst, cap_bucket)
        want = ex.bucket_exchange_plain(words, dest, n_dst, cap_bucket)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w_) for g, w_ in zip(got, want)):
            raise AssertionError(f"bucket_exchange at {label}: differs from its plain version")
        out_bytes = n_dst * n_src * cap_bucket * (4 * w + 1)
        out[label] = {
            "shape": f"n_src={n_src} cap_in={cap_in} w={w} n_dst={n_dst} "
                     f"cap_bucket={cap_bucket}",
            "kept": int(got[1].sum()), "sha256": digest(*got),
            "bound_ms": (words.numel() * 4 + dest.numel() * 4 + out_bytes) / 3.35e12 * 1e3,
            "ms": cuda_ms(torch, lambda: ex.bucket_exchange(words, dest, n_dst, cap_bucket), 50),
            "device": device_ms(torch, lambda: ex.bucket_exchange(words, dest, n_dst, cap_bucket),
                                20),
        }
    return out


def programs(torch, device):
    """The Table API phase's programs as its runner lowers them: the fused chain (the written-out
    pipeline, ``chip_smoke.py``'s ``chain_variant``) and the lifted ``a * 3 + 7`` that the
    lifted pipeline runs as one of its member expressions; and one commit of the phase's seeded
    columns (``chip_smoke.py``'s ``pipeline_columns``)."""
    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import fusion
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.internals.graph_runner import GraphRunner
    from pathway_tpu_torch.ops import expression_kernel as vm

    rng = np.random.default_rng(43)
    n = max(rows for _, rows in VM_CASES.values())
    cols = {"a": rng.integers(-2**31, 2**31, n).astype(np.int64),
            "g": rng.integers(0, 1 << 16, n).astype(np.int64),
            "x": rng.integers(-1024, 1024, n) / 16.0}
    pw.G.clear()
    t = pw.debug.table_from_rows(pw.schema_from_types(a=int, g=int, x=float), [(0, 0, 0.0)])
    chain = (t.select(g=pw.this.g, y=pw.this.a * 3 + 7, z=pw.this.x * 2.0 - 1.0)
             .filter(pw.this.z > -32.0)
             .select(g=pw.this.g,
                     w=pw.if_else(pw.this.y > 1000, pw.cast(float, pw.this.y & 1023) * pw.this.z,
                                  -pw.this.z)))
    res = chain.groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.w),
                                          c=pw.reducers.count())
    runner = GraphRunner(device)
    runner.capture(res)
    (fused,) = [m for m in fusion.fuse_graph(runner._nodes) if isinstance(m, fusion.FusedChain)]
    plan = fused._kernel_plan
    kinds = ec._input_kinds(list(cols), cols)
    env = ec.ColumnEnv(device=device)
    env.add_table(t)
    lifted = ec.expression_program(pw.apply_with_type(lambda a: a * 3 + 7, int, t.a), env,
                                   kinds, {})
    out = {"chain": ec.chain_program(plan, ec._input_kinds(plan["src_cols"], cols)),
           "lifted": lifted}
    for k in (8, 16):  # k dependent integer adds: the difference of the two is 8 steps' cost
        b = vm.ProgramBuilder({"a": "I"})
        v = b.load("a")
        for _ in range(k):
            v = b.binop("+", v, v)
        b.store("out", v)
        out[f"add{k}"] = b.finish()
    pw.G.clear()
    return out, cols


def machine(torch, vm) -> dict:
    import numpy as np

    progs, cols = programs(torch, torch.device("cuda"))
    out = {}
    for label, (which, n) in VM_CASES.items():
        prog = progs[which]
        in_offs, in_bytes, out_offs, out_bytes = vm.layout(prog, n)
        host_in = torch.zeros(in_bytes, dtype=torch.uint8)
        for (name, _), off in zip(prog.inputs, in_offs):
            host_in.numpy()[off:off + n * 8] = cols[name][:n].view(np.uint8)
        dev_in = host_in.cuda()
        dev_out = torch.zeros(out_bytes, dtype=torch.uint8, device="cuda")
        plain_out = torch.zeros_like(dev_out)
        vm.expression_vm(prog, dev_in, dev_out, n)
        vm.expression_vm_plain(prog, dev_in, plain_out, n)
        torch.cuda.synchronize()
        if not torch.equal(dev_out, plain_out):
            raise AssertionError(f"expression_vm at {label}: differs from its plain version")
        row = {
            "shape": f"{n} rows, {len(prog.inputs)} columns in, {len(prog.outputs)} out, "
                     f"{prog.code.shape[0]} instructions, {prog.n_regs} registers",
            "sha256": digest(dev_out), "bound_ms": (in_bytes + out_bytes) / 3.35e12 * 1e3,
            "ms": cuda_ms(torch, lambda: vm.expression_vm(prog, dev_in, dev_out, n), 100),
            "device": device_ms(torch, lambda: vm.expression_vm(prog, dev_in, dev_out, n), 50),
        }
        empty = getattr(vm, "expression_vm_empty", None)
        if empty is not None:
            dev = torch.device("cuda")
            row["empty_ms"] = cuda_ms(torch, lambda: empty(prog, dev, n), 100)
            row["empty_device"] = device_ms(torch, lambda: empty(prog, dev, n), 50)
        out[label] = row
    return out


def child(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from pathway_tpu_torch import _kernels
    from pathway_tpu_torch.ops import expression_kernel as vm
    from pathway_tpu_torch.parallel import exchange as ex

    logs = _kernels._build([n for n in ("bucket_exchange", "expression_vm")
                            if not _kernels._target(n).exists()])
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "stack")):
                print(f"{tree} {name}: {line.strip()}", file=sys.stderr)
    result = {"tree": tree, "bucket_exchange": exchange(torch, ex),
              "expression_vm": machine(torch, vm)}
    print(json.dumps(result), flush=True)


def main(trees: list[str]) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--child", tree], check=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
