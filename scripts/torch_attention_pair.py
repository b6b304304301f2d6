"""Hold and time the attention backward and the ring's block step of checkouts of
``pathway_tpu_torch`` on one card.

    python scripts/torch_attention_pair.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one). Every TREE runs in a process of its
own, in the order given, so that ``A B B A`` pairs two versions within one call on one card. A
process builds that tree's two kernels with ``nvcc`` (ptxas's report of each goes to standard
error), then, at the main paths' shapes:

- ``masked_attention_bwd`` at B=256, H=12, S=128, D=32 (the training step's, one layer of one
  view), on seeded inputs with ragged key lengths and one all-pad row: its dq, dk and dv against
  the plain version within 1e-2 plus one bf16 ulp of the value, the SHA-256 of their bytes (equal
  digests from two trees: equal bits), and its time beside the backward of
  ``scaled_dot_product_attention`` on the same inputs;
- ``ring_block_attention`` at B=4, H=12, 8192 queries against 8192 keys, D=32, bf16 (the
  long-context forward's, one layer), q a view of the fused qkv product as the layer passes it,
  key lengths 8192, 7192, 4219 and 1: its output from a fresh state against the plain version's,
  max |err| within 2e-5 plus 2e-5 of the value, and its time.

Times are CUDA events around back-to-back calls, the median of 5 rounds. Every process prints
one JSON line; the card's name and power limit come first.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROUNDS = 5
ATTN_ATOL, ATTN_RTOL = 1e-2, 2.0 ** -7
RING_TOL = 2e-5


def cuda_ms(fn, calls: int) -> float:
    import torch

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


def backward(torch, attention) -> dict:
    import torch.nn.functional as F

    B, H, S, D = 256, 12, 128, 32
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, dout = (torch.randn((B, H, S, D), generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
    lengths[0] = 0
    mask = torch.arange(S, device="cuda")[None, :] < lengths[:, None]
    _, stat = attention._forward(q, k, v, mask, with_stat=True)
    got = attention.masked_attention_bwd(q, k, v, dout, mask, stat)
    want = attention.masked_attention_bwd_plain(q, k, v, dout, mask)
    torch.cuda.synchronize()
    err = 0.0
    digest = hashlib.sha256()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        e = (g.float() - w.float()).abs()
        if not torch.isfinite(g.float()).all() or (e > ATTN_ATOL + ATTN_RTOL * w.float().abs()).any():
            raise AssertionError(f"masked_attention_bwd {name}: max |err| {e.max().item()}")
        err = max(err, e.max().item())
        digest.update(g.contiguous().view(torch.int16).cpu().numpy().tobytes())
    sdpa = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa, attn_mask=mask[:, None, None, :])
    return {
        "shape": f"B={B} H={H} S={S} D={D}", "max_abs_err": err, "sha256": digest.hexdigest(),
        "ms": cuda_ms(lambda: attention.masked_attention_bwd(q, k, v, dout, mask, stat), 20),
        "sdpa_bwd_ms": cuda_ms(
            lambda: torch.autograd.grad(sdpa_out, sdpa, dout, retain_graph=True), 20),
    }


def ring(torch, ring_ops) -> dict:
    B, S, H, D = 4, 8192, 12, 32
    gen = torch.Generator(device="cuda").manual_seed(20)
    qkv = torch.randn((B, S, 3 * H * D), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    qh, kh, vh = q.transpose(1, 2), k.contiguous().transpose(1, 2), v.contiguous().transpose(1, 2)
    lengths = torch.tensor([S, S - 1000, S // 2 + 123, 1], device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] < lengths[:, None]).to(torch.uint8)
    scale = D ** -0.5
    outs = []
    for fn in (ring_ops.ring_block_attention, ring_ops.ring_block_attention_plain):
        o, m, l = ring_ops.init_state(qh)
        out = torch.empty((B, H, S, D), dtype=torch.float32, device="cuda")
        fn(qh, kh, vh, mask, o, m, l, scale, out=out)
        outs.append(out)
    torch.cuda.synchronize()
    got, want = outs
    e = (got - want).abs()
    if not torch.isfinite(got).all() or (e > RING_TOL + RING_TOL * want.abs()).any():
        raise AssertionError(f"ring_block_attention: max |err| {e.max().item()}")
    err = e.max().item()
    # the error as a share of what the tolerance allows, at its worst element
    share = (e / (RING_TOL + RING_TOL * want.abs())).max().item()
    del outs, got, want, e
    o, m, l = ring_ops.init_state(qh)
    out = torch.empty((B, H, S, D), dtype=torch.float32, device="cuda")
    return {
        "shape": f"B={B} H={H} s=s_blk={S} D={D} bf16", "lengths": lengths.tolist(),
        "max_abs_err": err, "share_of_tolerance": share,
        "ms": cuda_ms(
            lambda: ring_ops.ring_block_attention(qh, kh, vh, mask, o, m, l, scale, out=out), 5),
    }


def child(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from pathway_tpu_torch import _kernels
    from pathway_tpu_torch.ops import attention
    from pathway_tpu_torch.ops import ring as ring_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    logs = _kernels._build([n for n in ("masked_attention", "masked_attention_bwd",
                                        "ring_attention") if not _kernels._target(n).exists()])
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"{tree} {name}: {line.strip()}", file=sys.stderr)
    result = {"tree": tree, "attention_bwd": backward(torch, attention),
              "ring": ring(torch, ring_ops)}
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
