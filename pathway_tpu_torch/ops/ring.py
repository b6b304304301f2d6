"""One step of ring attention: the wrapper of the hand-written CUDA kernel
``csrc/ring_attention.cu``, its launch count, and its plain PyTorch version.

The kernel replaces ``accumulate`` inside ``pathway_tpu/models/ring_attention.py``
``ring_attention`` (lines 80-91) and the division after the ring's last step (line 111): it folds
one block of keys and values into the running online-softmax state (o, m, l) of this rank's
queries, in f32 throughout, in place. On CUDA tensors :func:`ring_block_attention` launches it:
bf16 inputs take its tensor-core route (exact bf16 products, the weights split into three bf16
parts), f32 inputs its CUDA-core route; the dtype alone chooses. On CPU tensors it runs
:func:`ring_block_attention_plain`, the JAX expression step by step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels

__all__ = ["ring_block_attention", "ring_block_attention_plain", "init_state", "HEAD_DIMS", "NEG"]

#: head widths the kernel is built for (a template on D): every encoder config in the repository
HEAD_DIMS = (8, 16, 32, 64)
#: the masked score and the starting row max, as in the JAX program (not -inf)
NEG = -1e30


def init_state(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The state before the first block, for queries ``[B, H, s, D]``: o = 0, m = -1e30, l = 0,
    all f32 and contiguous."""
    B, H, s, D = q.shape
    o = torch.zeros((B, H, s, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, s), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, s), dtype=torch.float32, device=q.device)
    return o, m, l


def ring_block_attention_plain(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                               mask_blk: torch.Tensor, o: torch.Tensor, m: torch.Tensor,
                               l: torch.Tensor, scale: float,
                               out: torch.Tensor | None = None) -> None:
    """q ``[B, H, s, D]``, k_blk and v_blk ``[B, H, s_blk, D]`` (cast to f32), mask_blk
    ``[B, s_blk]`` (bool or bytes, non-zero keeps the key); the state o f32 ``[B, H, s, D]``, m
    and l f32 ``[B, H, s]`` is updated in place. If ``out`` (f32 ``[B, H, s, D]``, any strides)
    is given, it receives o / max(l, 1e-30). The score matrix of the block is built and reused in
    place, one f32 ``[B, H, s, s_blk]``."""
    scores = q.float() @ k_blk.float().transpose(-1, -2)
    scores.mul_(scale)
    scores.masked_fill_(~mask_blk.bool()[:, None, None, :], NEG)
    m_new = torch.maximum(m, scores.amax(-1))
    p = scores.sub_(m_new[..., None]).exp_()
    corr = torch.exp(m - m_new)
    l.mul_(corr).add_(p.sum(-1))
    o.mul_(corr[..., None]).add_(p @ v_blk.float())
    m.copy_(m_new)
    if out is not None:
        out.copy_(o / l.clamp_min(1e-30)[..., None])


@functools.cache
def _launcher():
    fn = _kernels.load("ring_attention").ring_block_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] + [
        ctypes.c_longlong
    ] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A bf16 ``t`` as the tensor-core route reads it, 16 bytes (8 values of a row) at a time:
    d contiguous, the other strides divisible by 8 and the base 16-byte aligned; other layouts
    are copied first. f32 tensors are returned as they are (that route takes any strides)."""
    if t.dtype != torch.bfloat16 or (
            t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in t.stride()[:3])):
        return t
    return t.contiguous()


def _check(q, k_blk, v_blk, mask_blk, o, m, l, out) -> None:
    B, H, s, D = q.shape
    s_blk = k_blk.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32) or D not in HEAD_DIMS or min(B, H, s) < 1:
        raise ValueError(
            f"ring_block_attention: kernel takes bf16 or f32 q of head width {HEAD_DIMS}, got "
            f"{q.dtype} {tuple(q.shape)}"
        )
    for name, t in (("k_blk", k_blk), ("v_blk", v_blk)):
        if t.dtype != q.dtype or t.shape != (B, H, s_blk, D) or t.device != q.device:
            raise ValueError(f"ring_block_attention: {name} must be {q.dtype} "
                             f"[{B}, {H}, s_blk, {D}] on {q.device}")
    for name, t in (("q", q), ("k_blk", k_blk), ("v_blk", v_blk), ("out", out)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"ring_block_attention: {name} must be contiguous in its last dim")
    if (mask_blk.dtype not in (torch.bool, torch.uint8) or mask_blk.shape != (B, s_blk)
            or mask_blk.stride(1) != 1 or mask_blk.device != q.device or s_blk < 1):
        raise ValueError("ring_block_attention: mask_blk must be bool or uint8 [B, s_blk] on the "
                         "device of q, contiguous in its last dim")
    for name, t, shape in (("o", o, (B, H, s, D)), ("m", m, (B, H, s)), ("l", l, (B, H, s)),
                           ("out", out, (B, H, s, D))):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.shape != shape or t.device != q.device or (
                name != "out" and not t.is_contiguous()):
            raise ValueError(f"ring_block_attention: {name} must be f32 {list(shape)} on "
                             f"{q.device}" + ("" if name == "out" else ", contiguous"))


def ring_block_attention(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                         mask_blk: torch.Tensor, o: torch.Tensor, m: torch.Tensor,
                         l: torch.Tensor, scale: float, out: torch.Tensor | None = None) -> None:
    """Fold one block of keys into the state (o, m, l), as :func:`ring_block_attention_plain`
    computes it; with ``out``, also write the normalised output.

    On CUDA tensors one launch of the kernel does it (q, k_blk and v_blk bf16 or f32 of one dtype
    with head widths ``HEAD_DIMS``, any strides with the last dim contiguous; bf16 rows that are
    not 16-byte aligned are copied first); bf16 takes the kernel's tensor-core route, f32 its
    CUDA-core route. On CPU tensors it runs the plain version."""
    if q.device.type == "cpu":
        return ring_block_attention_plain(q, k_blk, v_blk, mask_blk, o, m, l, scale, out)
    if q.device.type != "cuda":
        raise ValueError(f"ring_block_attention: no kernel for device {q.device}")
    _check(q, k_blk, v_blk, mask_blk, o, m, l, out)
    q, k_blk, v_blk = (_aligned(t) for t in (q, k_blk, v_blk))
    B, H, s, D = q.shape
    s_blk = k_blk.shape[2]
    out_strides = out.stride()[:3] if out is not None else (0, 0, 0)
    err = _launcher()(
        q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), mask_blk.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), None if out is None else out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, s, s_blk, D, float(scale),
        *q.stride()[:3], *k_blk.stride()[:3], *v_blk.stride()[:3], *out_strides,
        mask_blk.stride(0), _kernels.stream(q.device),
    )
    _kernels.check(err, "ring_block_attention")
    ring_block_attention.launches += 1
    return None


ring_block_attention.launches = 0
