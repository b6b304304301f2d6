"""The symmetric InfoNCE loss of the training step: the wrapper of the hand-written CUDA kernel
``csrc/infonce.cu``, its launch count, and its plain PyTorch version.

The kernel replaces the loss of ``pathway_tpu/models/pipeline.py`` ``make_step`` (lines 61-67)
and its gradient: from the logits it computes the loss and d loss / d logits in one launch, since
``value_and_grad`` needs both. It is a row-and-column reduction, which Triton would also serve; it
is CUDA C++ so that the port keeps one toolchain (``nvcc`` through ``_kernels``).

Two routes, chosen by B alone: B <= ``CLUSTER_MAX_B`` (the training step's B=256) runs on a
thread block cluster of 8 blocks that hold a slice of the rows each and exchange their column
statistics through distributed shared memory; a larger B runs on one block of 1024 threads.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels

__all__ = ["infonce", "infonce_plain", "infonce_empty", "CLUSTER_MAX_B"]

#: largest B of the cluster route (kClusterMaxB in csrc/infonce.cu): a block of the cluster holds
#: ceil(B / 8) rows of B f32 logits in shared memory
CLUSTER_MAX_B = 640


def infonce_plain(logits: torch.Tensor) -> torch.Tensor:
    """f32 logits ``[B, B]`` -> the scalar loss of the JAX step: ``jax.nn.log_softmax`` over the
    rows and over the columns, the diagonal of each, their means, negated and summed."""
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (
        -torch.log_softmax(logits, dim=-1)[labels, labels].mean()
        - torch.log_softmax(logits.T, dim=-1)[labels, labels].mean()
    )


@functools.cache
def _launcher():
    fn = _kernels.load("infonce").infonce
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


class _InfoNCE(torch.autograd.Function):
    """The kernel's loss; its gradient, saved from the same launch, scaled by the upstream one."""

    @staticmethod
    def forward(ctx, logits):
        B = logits.shape[0]
        logits = logits.contiguous()
        if logits.data_ptr() % 16:  # the kernel reads rows 16 bytes at a time
            logits = logits.clone()
        # the block route's scratch of row and column log-sum-exps; the cluster route keeps them
        # in shared memory
        lse = None if B <= CLUSTER_MAX_B else torch.empty(
            (2 * B,), dtype=torch.float32, device=logits.device)
        grad = torch.empty((B, B), dtype=torch.float32, device=logits.device)
        loss = torch.empty((), dtype=torch.float32, device=logits.device)
        err = _launcher()(
            logits.data_ptr(), B, None if lse is None else lse.data_ptr(), grad.data_ptr(),
            loss.data_ptr(), _kernels.stream(logits.device),
        )
        _kernels.check(err, "infonce")
        infonce.launches += 1
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return grad * g


def infonce(logits: torch.Tensor) -> torch.Tensor:
    """The loss of :func:`infonce_plain`, differentiable with respect to ``logits``.

    On CUDA tensors (f32 ``[B, B]``, B >= 1) one launch of the kernel computes the loss and its
    gradient, on the cluster route up to ``CLUSTER_MAX_B`` and on the one-block route past it; on
    CPU tensors it runs the plain version."""
    if logits.device.type == "cpu":
        return infonce_plain(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"infonce: no kernel for device {logits.device}")
    if logits.dtype != torch.float32 or logits.dim() != 2 or logits.shape[0] != logits.shape[1] \
            or logits.shape[0] < 1:
        raise ValueError(f"infonce: kernel takes f32 [B, B] logits, got {logits.dtype} "
                         f"{tuple(logits.shape)}")
    return _InfoNCE.apply(logits)


infonce.launches = 0


@functools.cache
def _empty_launcher():
    fn = _kernels.load("infonce").infonce_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def infonce_empty(B: int, device: torch.device) -> None:
    """Launch an empty kernel on the grid, cluster and shared memory that :func:`infonce` takes
    for B on ``device``: the launch's own cost, beside which the kernel's time is read. It is no
    launch of the kernel and is not counted."""
    _kernels.check(_empty_launcher()(B, _kernels.stream(device)), "infonce_empty")
