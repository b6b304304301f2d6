"""Masked multi-head attention of the encoder and its gradient: the wrappers of the hand-written
CUDA kernels ``csrc/masked_attention.cu`` (forward) and ``csrc/masked_attention_bwd.cu``
(backward), their launch counts, and their plain PyTorch versions.

The forward replaces the attention expression inside ``pathway_tpu/models/embedder.py``
``_block`` (lines 90-101) and ``_bert_block`` (lines 120-127); the backward replaces the VJP of
that expression that ``jax.value_and_grad`` takes inside ``pathway_tpu/models/pipeline.py``
``make_step``. On CUDA tensors that need a gradient, :func:`masked_attention` runs as a
``torch.autograd.Function``: its forward also keeps each query row's softmax statistic, and its
backward launches the backward kernel. On CPU tensors it is the plain expression, which autograd
differentiates.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _kernels

__all__ = [
    "masked_attention", "masked_attention_plain", "masked_attention_bwd",
    "masked_attention_bwd_plain", "persistent_ctas_per_sm", "shared_memory_bytes",
    "backward_blocks_per_sm", "backward_shared_memory_bytes", "MAX_SEQ", "HEAD_DIMS",
    "PERSISTENT_MAX_SEQ", "FUSED_BWD_MAX_SEQ",
]

#: the kernels keep one head's K and V (or Q and dO) in shared memory
MAX_SEQ = 512
#: head widths the kernels are built for (a template on D)
HEAD_DIMS = (16, 32, 64)
#: the forward's persistent route (TMA-fed stages, scores in registers) takes S up to this; a
#: longer S takes its per-head route (kTmaMaxSeq in csrc/masked_attention.cu)
PERSISTENT_MAX_SEQ = 128
#: the backward's fused route (one kernel, each score's s, dp and exponential once) takes S up to
#: this; a longer S takes its two-kernel route, which needs a delta scratch (kFusedMaxSeq in
#: csrc/masked_attention_bwd.cu)
FUSED_BWD_MAX_SEQ = 128


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """q, k, v ``[B, H, S, D]`` in the working dtype, key mask bool ``[B, S]`` ->
    ``[B, H, S, D]``: the JAX expression step by step. The product q.kᵀ keeps the working dtype
    (bf16 @ bf16 is bf16 in JAX) before the cast to f32; padded keys get -1e30, so an all-pad row
    attends uniformly; the softmax is f32 and is cast back before the product with v."""
    scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    att = torch.softmax(scores, dim=-1).to(q.dtype)
    return att @ v


def masked_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               dout: torch.Tensor, mask: torch.Tensor):
    """(dq, dk, dv): autograd of :func:`masked_attention_plain` for the cotangent ``dout``, the
    function the backward kernel computes."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = masked_attention_plain(*leaves, mask)
        return torch.autograd.grad(out, leaves, dout)


@functools.cache
def _launcher():
    fn = _kernels.load("masked_attention").masked_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 13 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _query(lib: str, name: str):
    fn = getattr(_kernels.load(lib), name)
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def persistent_ctas_per_sm(D: int, S: int) -> int:
    """CTAs per SM of the forward's persistent route at head width D and sequence length
    S <= ``PERSISTENT_MAX_SEQ`` on the current card (its grid is this times the SM count, or
    B * H where that is smaller); 0 for a longer S."""
    return _query("masked_attention", "masked_attention_ctas_per_sm")(D, S)


def shared_memory_bytes(D: int, S: int) -> int:
    """The dynamic shared memory a block of the forward asks for at head width D and sequence
    length S, on the route S takes (the persistent one up to ``PERSISTENT_MAX_SEQ``)."""
    return _query("masked_attention", "masked_attention_smem_bytes")(D, S)


def backward_blocks_per_sm(D: int, S: int) -> int:
    """Blocks per SM of the backward's fused route at head width D and sequence length
    S <= ``FUSED_BWD_MAX_SEQ`` on the current card (one block per (b, h)); 0 for a longer S."""
    return _query("masked_attention_bwd", "masked_attention_bwd_blocks_per_sm")(D, S)


def backward_shared_memory_bytes(D: int, S: int) -> int:
    """The dynamic shared memory a block of the backward asks for at head width D and sequence
    length S, on the route S takes (the fused one up to ``FUSED_BWD_MAX_SEQ``, else the larger
    of the two kernels')."""
    return _query("masked_attention_bwd", "masked_attention_bwd_smem_bytes")(D, S)


@functools.cache
def _bwd_launcher():
    fn = _kernels.load("masked_attention_bwd").masked_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it, 16 bytes (8 values of a row) at a time: d contiguous, the
    other strides divisible by 8 (and above 0 where the dimension steps) and the base 16-byte
    aligned; other layouts are copied first."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 and (st > 0 or n == 1)
                    for st, n in zip(t.stride()[:3], t.shape[:3]))):
        return t
    return t.contiguous()


def _check(name: str, q: torch.Tensor, tensors, mask: torch.Tensor) -> None:
    B, H, S, D = q.shape
    for arg, t in tensors:
        if t.dtype != torch.bfloat16 or t.shape != q.shape or t.device != q.device:
            raise ValueError(
                f"{name}: {arg} must be bf16 {tuple(q.shape)} on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if D not in HEAD_DIMS or not 1 <= S <= MAX_SEQ or B < 1 or H < 1:
        raise ValueError(
            f"{name}: kernel takes head widths {HEAD_DIMS} and 1 <= S <= {MAX_SEQ}, "
            f"got {tuple(q.shape)}"
        )
    if mask.dtype != torch.bool or mask.shape != (B, S) or mask.device != q.device:
        raise ValueError(f"{name}: mask must be bool [B, S] on the device of q")


def _heads_out(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``[B, H, S, D]`` laid out as ``[B, S, H, D]``, so that merging the heads
    back is free."""
    B, H, S, D = q.shape
    return torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)


def _forward(q, k, v, mask, with_stat: bool):
    """One launch of the forward kernel; returns the output and, if asked, the row statistic
    f32 ``[B, H, S, 2]`` (row max, row sum of exponentials)."""
    B, H, S, D = q.shape
    out = _heads_out(q)
    stat = torch.empty((B, H, S, 2), dtype=torch.float32, device=q.device) if with_stat else None
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if stat is None else stat.data_ptr(), B, H, S, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        mask.stride(0), _kernels.stream(q.device),
    )
    _kernels.check(err, "masked_attention")
    masked_attention.launches += 1
    return out, stat


def masked_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
                         mask: torch.Tensor, stat: torch.Tensor):
    """(dq, dk, dv) of :func:`masked_attention` for the cotangent ``dout``, as
    :func:`masked_attention_bwd_plain` computes them, from the forward's row statistic ``stat``.

    CUDA tensors only: q, k, v, dout bf16 ``[B, H, S, D]`` as the forward takes them, mask bool
    ``[B, S]``, stat f32 ``[B, H, S, 2]``. The gradients come laid out as ``[B, S, H, D]``.
    S <= ``FUSED_BWD_MAX_SEQ`` (every launch of the training path) takes the fused kernel, a
    longer S the two-kernel route with its delta scratch; nothing else chooses. One launch of the
    wrapper counts once either way."""
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention_bwd: no kernel for device {q.device}")
    _check("masked_attention_bwd", q, (("k", k), ("v", v), ("dout", dout)), mask)
    B, H, S, D = q.shape
    if stat.dtype != torch.float32 or stat.shape != (B, H, S, 2) or not stat.is_contiguous():
        raise ValueError("masked_attention_bwd: stat must be the forward's f32 [B, H, S, 2]")
    q, k, v, dout = (_aligned(t) for t in (q, k, v, dout))
    if mask.stride(1) != 1:
        mask = mask.contiguous()
    dq, dk, dv = _heads_out(q), _heads_out(q), _heads_out(q)
    delta = (None if S <= FUSED_BWD_MAX_SEQ
             else torch.empty((B, H, S), dtype=torch.float32, device=q.device))
    strides = (ctypes.c_longlong * 21)(
        *(st for t in (q, k, v, dout, dq, dk, dv) for st in t.stride()[:3])
    )
    err = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), mask.data_ptr(),
        stat.data_ptr(), None if delta is None else delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        B, H, S, D, ctypes.addressof(strides), mask.stride(0),
        _kernels.stream(q.device),
    )
    _kernels.check(err, "masked_attention_bwd")
    masked_attention_bwd.launches += 1
    return dq, dk, dv


class _MaskedAttention(torch.autograd.Function):
    """The forward kernel with its statistic; the backward kernel for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        out, stat = _forward(q, k, v, mask, with_stat=True)
        ctx.save_for_backward(q, k, v, mask, stat)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, stat = ctx.saved_tensors
        dq, dk, dv = masked_attention_bwd(q, k, v, dout, mask, stat)
        return dq, dk, dv, None


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Masked attention, as :func:`masked_attention_plain` computes it.

    On CUDA tensors it launches the kernel, which takes bf16 q, k, v of shape ``[B, H, S, D]``
    with D in ``HEAD_DIMS`` and S <= 512, in any layout whose rows are 16-byte aligned (the heads
    may be views of the fused qkv product; other layouts are copied first), and a bool mask
    ``[B, S]``. S <= ``PERSISTENT_MAX_SEQ`` (every launch of the encoder's main paths) takes the
    kernel's persistent route, a longer S its per-head route; nothing else chooses. It returns
    ``[B, H, S, D]`` laid out as ``[B, S, H, D]`` in memory, so that
    merging the heads back is free. Where autograd records (grad mode on and q, k or v requiring a
    gradient) the result is part of the graph, and its backward launches
    :func:`masked_attention_bwd`. On CPU tensors it runs the plain version."""
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention: no kernel for device {q.device}")
    _check("masked_attention", q, (("q", q), ("k", k), ("v", v)), mask)
    q, k, v = (_aligned(t) for t in (q, k, v))
    if mask.stride(1) != 1:
        mask = mask.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _MaskedAttention.apply(q, k, v, mask)
    return _forward(q, k, v, mask, with_stat=False)[0]


masked_attention.launches = 0
masked_attention_bwd.launches = 0
