"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain PyTorch versions, and the ``autograd.Function`` that joins them.

Non-causal, unmasked multi-head attention over ``(B, H, T, D)`` by online
softmax, QKVAttentionLegacy scaling (q and k each times ``D**-0.25``), float32
logits, softmax and accumulator whatever the operands' type; optionally the
per-row log-sum-exp of the logits, ``(B*H, T)`` float32, which the backward
needs.

* ``flash_attention(q, k, v, emit_lse=False)`` — on CUDA tensors launches
  kernel ``flash_fwd`` (``csrc/flash_attention.cu``: ``flash_fwd_wgmma_kernel``
  in bfloat16 at D = 64 and 128, ``flash_fwd_kernel`` otherwise), which
  replaces the TPU kernel ``pai_tpu/kernels/flash_attention.py::_fwd_kernel``
  (both of its instantiations); on CPU tensors takes the plain version. When
  a gradient is wanted it goes through ``FlashAttention``, as the JAX function
  goes through its ``custom_vjp``.
* ``flash_attention_backward(q, k, v, o, lse, do)`` — ``(dq, dk, dv)``: on
  CUDA tensors launches kernels ``flash_bwd_dq`` and ``flash_bwd_dkv``
  (``csrc/flash_attention_bwd.cu``; dkv as ``flash_bwd_dkv_wgmma_kernel`` in
  bfloat16 at D = 64 and 128), which replace ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``; ``delta = rowsum(do * o)`` is one PyTorch op before
  them, as the JAX package computes it in XLA. On CPU tensors the plain
  version.
* ``flash_attention_plain`` / ``flash_attention_backward_plain`` — the same
  functions as blockwise PyTorch (``pai_tpu/ops/attention.py::
  _blockwise_attention`` and ``_flash_backward``'s formulas): the oracles the
  kernels are held against. A full 16,384 x 16,384 logits tensor would be
  1 GB per head, hence blockwise.

Bound on an H100: operations — ``4*B*H*T*T*D`` forward, ``6*...`` for dq and
``8*...`` for dk and dv, against some ``4-8*B*H*T*D`` elements moved. All
three kernels run on the tensor cores (989 TFLOP/s dense bf16; float32 as
3xTF32, float32 accuracy at up to a third of the 495 TFLOP/s TF32 rate), by
a route fixed by the operands' type and head dim in the sources'
``launch_for_d``: the forward and dkv in bfloat16 at D = 64 and 128 on
Hopper's warpgroup ``wgmma`` with TMA tile loads (``csrc/flash_wgmma.cuh``),
everything else on warp-level ``mma.sync`` (``csrc/flash_mma.cuh``). No
launch falls back to another route. The kernels' designs are described at
the top of their ``.cu`` sources; measured times are in PERF.md.

The wrappers take strided views (last dimension contiguous, the other strides
multiples of 16 bytes): the q, k, v slices of one packed
``(N, T, heads, 3, D)`` tensor are read in place. Their outputs are
token-major in memory — a ``(B, H, T, D)`` view of a contiguous
``(B, T, H, D)`` buffer — so ``out.permute(0, 2, 1, 3).reshape(B, T, H * D)``
is a view too and the projection that follows attention needs no transpose.

``D`` must be 32, 64, 128 or 256 and ``T`` a multiple of 128, on any device;
anything else raises ``ValueError``. No shape sends a CUDA tensor to a plain
version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple, Union

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


def flash_attention_backward_flops(shape) -> Tuple[int, int]:
    """Operations of the two backward kernels on ``(B, H, T, D)`` operands:
    dq recomputes the logits and ``dO V^T`` and forms ``dS K`` (three products
    of ``2*T*T*D``), dkv does the same two plus ``P^T dO`` and ``dS^T Q``
    (four)."""
    b, h, t, d = shape
    return 6 * b * h * t * t * d, 8 * b * h * t * t * d


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


def _check_backward(q, k, v, o, lse, do) -> None:
    _check(q, k, v)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"flash_attention_backward: {name} must match q "
                f"{tuple(q.shape)} {q.dtype}, got {tuple(x.shape)} {x.dtype}")
    b, h, t, _ = q.shape
    if lse.shape != (b * h, t) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(
            "flash_attention_backward: lse must be float32 (B*H, T) = "
            f"{(b * h, t)}, got {tuple(lse.shape)} {lse.dtype}")


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(do * o)``, ``(B*H, T)`` float32."""
    b, h, t, _ = o.shape
    return (do.float() * o.float()).sum(dim=-1).reshape(b * h, t)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor
                                   ) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv)`` of ``flash_attention`` by the explicit blockwise
    formulas of ``pai_tpu/kernels/flash_attention.py::_flash_backward``:
    ``P = exp(s^2 q k^T - lse)``, ``dS = P (do v^T - delta)``,
    ``dq = s^2 dS k``, ``dk = s^2 dS^T q``, ``dv = P^T do``, with ``s^2 =
    D**-0.5``. ``lse`` is taken as given (a caller may pass one that spans
    more keys than ``k`` holds). Computes in float32; returns the operands'
    dtype."""
    _check_backward(q, k, v, o, lse, do)
    b, h, t, d = q.shape
    s2 = d ** -0.5
    block = _plain_block(t)
    with torch.autocast(device_type=q.device.type, enabled=False):
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        lse4 = lse.reshape(b, h, t, 1)
        delta = _delta(o, do).reshape(b, h, t, 1)
        dq = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
        dk = torch.zeros_like(dq)
        dv = torch.zeros_like(dq)
        for q0 in range(0, t, block):
            rows = slice(q0, q0 + block)
            for k0 in range(0, t, block):
                cols = slice(k0, k0 + block)
                logits = torch.matmul(qf[:, :, rows],
                                      kf[:, :, cols].transpose(-1, -2)) * s2
                p = torch.exp(logits - lse4[:, :, rows])
                dp = torch.matmul(dof[:, :, rows],
                                  vf[:, :, cols].transpose(-1, -2))
                ds = p * (dp - delta[:, :, rows])
                dq[:, :, rows] += torch.matmul(ds, kf[:, :, cols])
                dk[:, :, cols] += torch.matmul(ds.transpose(-1, -2),
                                               qf[:, :, rows])
                dv[:, :, cols] += torch.matmul(p.transpose(-1, -2),
                                               dof[:, :, rows])
        dq *= s2
        dk *= s2
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


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


def _backward_library() -> ctypes.CDLL:
    lib = kernels.load_library("flash_attention_bwd")
    if not getattr(lib, "_pai_declared", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.pai_flash_bwd_dq.argtypes = (
            [ptr] * 7 + [i32] * 5 + [strides, ptr])
        lib.pai_flash_bwd_dkv.argtypes = (
            [ptr] * 8 + [i32] * 5 + [strides, ptr])
        lib.pai_flash_bwd_dq.restype = i32
        lib.pai_flash_bwd_dkv.restype = i32
        lib._pai_declared = True
    return lib


def _token_major(b: int, h: int, t: int, d: int, like: torch.Tensor
                 ) -> torch.Tensor:
    """A ``(B, H, T, D)`` view of a new contiguous ``(B, T, H, D)`` buffer."""
    return torch.empty((b, t, h, d), dtype=like.dtype, device=like.device
                       ).permute(0, 2, 1, 3)


def _takes_layout(x: torch.Tensor) -> bool:
    """Contiguous along D, the other strides whole 16-byte copies (4 float32
    or 8 bfloat16 elements), 16-byte aligned: what the kernels' cp.async
    tile copies and TMA tensor maps need."""
    vec = 16 // x.element_size()
    return x.stride(3) == 1 and not any(s % vec for s in x.stride()[:3]) \
        and x.data_ptr() % 16 == 0


def _check_strides(name: str, x: torch.Tensor) -> None:
    if not _takes_layout(x):
        raise ValueError(
            f"flash_attention: {name} must be contiguous along D, with "
            "batch, head and row strides that are multiples of 4 elements "
            "(float32) or 8 (bfloat16) and 16-byte aligned storage; got "
            f"strides {x.stride()}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            emit_lse: bool) -> Result:
    b, h, t, d = q.shape
    if b * h > 65535:
        raise ValueError(
            f"flash_attention: B*H = {b * h} exceeds the grid's 65,535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_strides(name, x)
    lib = _library()
    out = _token_major(b, h, t, d, q)
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


class BackwardLaunch(NamedTuple):
    """Everything the two backward kernels of one call are launched with."""
    lib: ctypes.CDLL
    inputs: tuple      # q, k, v, do, lse, delta pointers
    common: tuple      # B, H, T, D, dtype code, strides
    dq: torch.Tensor
    dk: torch.Tensor
    dv: torch.Tensor
    keep: tuple        # tensors the pointers point into
    flops: Tuple[int, int]


def prepare_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                     ) -> BackwardLaunch:
    """Check the CUDA operands, compute ``delta`` and allocate the
    token-major outputs of one backward call."""
    b, h, t, d = q.shape
    if b * h > 65535:
        raise ValueError(
            f"flash_attention_backward: B*H = {b * h} exceeds the grid's "
            "65,535")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_strides(name, x)
    lse = lse.contiguous()
    if lse.data_ptr() % 16:  # the dkv kernels copy lse rows 16 bytes at a time
        lse = lse.clone()
    delta = _delta(o, do)
    dq, dk, dv = (_token_major(b, h, t, d, q) for _ in range(3))
    strides = (ctypes.c_longlong * 21)(*(
        s for x in (q, k, v, do, dq, dk, dv) for s in x.stride()[:3]))
    return BackwardLaunch(
        lib=_backward_library(),
        inputs=(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr()),
        common=(b, h, t, d, _DTYPE_CODES[q.dtype], strides),
        dq=dq, dk=dk, dv=dv, keep=(q, k, v, do, lse, delta),
        flops=flash_attention_backward_flops(q.shape))


def launch_dq(call: BackwardLaunch) -> None:
    """Kernel ``flash_bwd_dq`` into ``call.dq``."""
    with torch.cuda.device(call.dq.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = call.lib.pai_flash_bwd_dq(*call.inputs, call.dq.data_ptr(),
                                         *call.common, stream)
    kernels.check_launch(code, "flash_bwd_dq")
    kernels.launch_counts["flash_bwd_dq"] += 1
    kernels.launched_flops += call.flops[0]


def launch_dkv(call: BackwardLaunch) -> None:
    """Kernel ``flash_bwd_dkv`` into ``call.dk`` and ``call.dv``."""
    with torch.cuda.device(call.dq.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = call.lib.pai_flash_bwd_dkv(*call.inputs, call.dk.data_ptr(),
                                          call.dv.data_ptr(), *call.common,
                                          stream)
    kernels.check_launch(code, "flash_bwd_dkv")
    kernels.launch_counts["flash_bwd_dkv"] += 1
    kernels.launched_flops += call.flops[1]


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor
                             ) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv)`` given the forward's output ``o``, its ``lse`` and the
    output gradient ``do``: kernels ``flash_bwd_dq`` and ``flash_bwd_dkv`` on
    CUDA tensors (token-major outputs), the plain version on CPU tensors."""
    _check_backward(q, k, v, o, lse, do)
    if not q.is_cuda:  # CPU tensors: the plain version
        return flash_attention_backward_plain(q, k, v, o, lse, do)
    call = prepare_backward(q, k, v, o, lse, do)
    launch_dq(call)
    launch_dkv(call)
    return call.dq, call.dk, call.dv


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             emit_lse: bool) -> Result:
    if not q.is_cuda:  # CPU tensors: the plain version
        return flash_attention_plain(q, k, v, emit_lse)
    return _launch(q, k, v, emit_lse)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward: the forward keeps ``lse`` and
    its output, the backward hands them to ``flash_attention_backward`` (the
    JAX function's ``custom_vjp`` rules)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward(q, k, v, emit_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        if not _takes_layout(grad):
            grad = grad.contiguous()
        return flash_attention_backward(q, k, v, out, lse, grad)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    emit_lse: bool = False) -> Result:
    """``(B, H, T, D)`` attention output (and ``lse`` ``(B*H, T)`` with
    ``emit_lse``): the ``flash_fwd`` kernel on CUDA tensors, the plain
    version on CPU tensors. Differentiable through ``FlashAttention`` when a
    gradient is wanted (``lse`` is not: asking for it then raises)."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if emit_lse:
            raise ValueError(
                "flash_attention: lse is not differentiable; call it with "
                "emit_lse=True under torch.no_grad() or on tensors that do "
                "not require grad")
        return FlashAttention.apply(q, k, v)
    return _forward(q, k, v, emit_lse)
