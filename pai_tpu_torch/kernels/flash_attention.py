"""Flash-attention forward: the CUDA kernel's wrapper, and its plain PyTorch
version.

Non-causal, unmasked multi-head attention over ``(B, H, T, D)`` by online
softmax, QKVAttentionLegacy scaling (q and k each times ``D**-0.25``), float32
logits, softmax and accumulator whatever the operands' type; optionally the
per-row log-sum-exp of the logits, ``(B*H, T)`` float32, which a backward pass
needs.

* ``flash_attention(q, k, v, emit_lse=False)`` — on CUDA tensors launches
  kernel ``flash_fwd`` (``csrc/flash_attention.cu::flash_fwd_kernel``), which
  replaces the TPU kernel ``pai_tpu/kernels/flash_attention.py::_fwd_kernel``
  (both of its instantiations); on CPU tensors takes the plain version.
* ``flash_attention_plain(q, k, v, emit_lse=False)`` — the same function as
  blockwise PyTorch (``pai_tpu/ops/attention.py::_blockwise_attention``): the
  oracle the kernel is held against. A full 16,384 x 16,384 logits tensor
  would be 1 GB per head, hence blockwise.

Bound on an H100 (67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s HBM3):
operations — ``4*B*H*T*T*D`` of them against ``4*B*H*T*D`` elements moved, T
operations per element. The kernel's design (one block per 128 query rows
looping over 64-row K/V tiles, register-tiled float32 FMAs for both products,
state in registers, K/V prefetched by ``cp.async``) is described at the top of
the ``.cu`` source; measured times are in PERF.md.

The wrapper takes strided views (last dimension contiguous, the other strides
multiples of 4 elements): the q, k, v slices of one packed
``(N, T, heads, 3, D)`` tensor are read in place. Its output is token-major in
memory — a ``(B, H, T, D)`` view of a contiguous ``(B, T, H, D)`` buffer — so
``out.permute(0, 2, 1, 3).reshape(B, T, H * D)`` is a view too and the
projection that follows attention needs no transpose.

``D`` must be 32, 64, 128 or 256 and ``T`` a multiple of 128, on any device;
anything else raises ``ValueError``. No shape sends a CUDA tensor to the plain
version. There is no backward kernel yet (ROADMAP.md Queue B items 4-5): a
tensor that requires grad, under grad mode, raises ``NotImplementedError`` on
the card instead of differentiating through a stand-in.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from pai_tpu_torch import kernels

HEAD_DIMS = (32, 64, 128, 256)
BLOCK_Q = 128  # the kernel's query tile; T must be a multiple of it
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def flash_attention_flops(shape) -> int:
    """Operations of one call on ``(B, H, T, D)`` operands: two products of
    ``2*T*T*D`` each per head."""
    b, h, t, d = shape
    return 4 * b * h * t * t * d


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "flash_attention expects three (B, H, T, D) tensors of one shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention is built for head dims {HEAD_DIMS}, got {d}")
    if b < 1 or h < 1 or t < 1 or t % BLOCK_Q:
        raise ValueError(
            f"flash_attention needs T a positive multiple of {BLOCK_Q}, got "
            f"{tuple(q.shape)}")


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------
def _plain_block(t: int) -> int:
    block = 1024
    while t % block:
        block //= 2
    return block


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          emit_lse: bool = False) -> Result:
    """Blockwise online-softmax attention in plain PyTorch, exact (not an
    approximation): the running maximum ``m``, denominator ``l`` and
    accumulator are carried from one K/V block to the next, ``m`` starting at
    ``-inf`` so the first block's ``alpha`` is ``exp(-inf) = 0``. Computes in
    float32; returns the operands' dtype (and ``lse``, ``(B*H, T)`` float32,
    when asked)."""
    _check(q, k, v)
    b, h, t, d = q.shape
    scale = d ** -0.25
    block = _plain_block(t)
    with torch.autocast(device_type=q.device.type, enabled=False):
        qs = q.float() * scale
        ks = k.float() * scale
        vs = v.float()
        out = torch.empty((b, h, t, d), dtype=torch.float32, device=q.device)
        lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        for q0 in range(0, t, block):
            q_blk = qs[:, :, q0:q0 + block]
            m = torch.full((b, h, block, 1), float("-inf"),
                           dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((b, h, block, d), dtype=torch.float32,
                              device=q.device)
            for k0 in range(0, t, block):
                logits = torch.matmul(
                    q_blk, ks[:, :, k0:k0 + block].transpose(-1, -2))
                m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
                p = torch.exp(logits - m_new)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.matmul(p, vs[:, :, k0:k0 + block])
                m = m_new
            out[:, :, q0:q0 + block] = acc / l
            lse[:, :, q0:q0 + block] = (m + torch.log(l))[..., 0]
    out = out.to(q.dtype)
    if emit_lse:
        return out, lse.reshape(b * h, t)
    return out


# --------------------------------------------------------------------------
# the kernel's launcher
# --------------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    lib = kernels.load_library("flash_attention")
    if not getattr(lib, "_pai_declared", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.pai_flash_fwd.argtypes = (
            [ptr] * 5 + [i32] * 5 + [i64] * 12 + [ptr])
        lib.pai_flash_fwd.restype = i32
        lib._pai_declared = True
    return lib


def _check_strides(name: str, x: torch.Tensor) -> None:
    if x.stride(3) != 1 or any(s % 4 for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {name} must be contiguous along D, with "
            "batch, head and row strides that are multiples of 4 elements "
            f"and 16-byte aligned storage; got strides {x.stride()}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            emit_lse: bool) -> Result:
    b, h, t, d = q.shape
    if b * h > 65535:
        raise ValueError(
            f"flash_attention: B*H = {b * h} exceeds the grid's 65,535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_strides(name, x)
    lib = _library()
    # token-major storage, seen as (B, H, T, D)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device
                      ).permute(0, 2, 1, 3)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device) \
        if emit_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pai_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if emit_lse else None, b, h, t, d,
            _DTYPE_CODES[q.dtype], *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], stream)
    kernels.check_launch(code, "flash_fwd")
    kernels.launch_counts["flash_fwd"] += 1
    kernels.launched_flops += flash_attention_flops(q.shape)
    return (out, lse) if emit_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    emit_lse: bool = False) -> Result:
    """``(B, H, T, D)`` attention output (and ``lse`` ``(B*H, T)`` with
    ``emit_lse``): the ``flash_fwd`` kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check(q, k, v)
    if not q.is_cuda:  # CPU tensors: the plain version
        return flash_attention_plain(q, k, v, emit_lse)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward kernel on the card yet: "
            "ROADMAP.md Queue B items 4-5 (flash dq and dkv, the Palette "
            "training slice). Call it under torch.no_grad() / "
            "inference_mode() or on tensors that do not require grad.")
    return _launch(q, k, v, emit_lse)
