"""K2 on Hopper: forward-only GQA flash attention, CUDA C++ for sm_90a.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_kernel``
(Pallas body ``_flash_kernel``). The kernel is ``csrc/flash_attention.cu``,
with one design per (dtype, head_dim); the library chooses it, and
``kernel_design`` reads its name from there:

* ``"tma-wgmma-ws"`` (bf16, head_dim 64 and 128): one block of three
  warpgroups per (batch * head, 128-query tile); a producer warpgroup
  streams 128-key K/V tiles by TMA through an mbarrier ring, and two
  consumer warpgroups run both products on ``wgmma`` with the online
  softmax in registers;
* ``"mma-sync"`` (bf16, head_dim 80) and ``"fma"`` (f32): one 4-warp block
  per (batch * head, 64-query tile), 64-key K/V tiles staged in shared
  memory, ``mma.sync`` bf16 products or FMA in f32.

Every design clips the key loop to the causal limit and the window; the
source's header says what bounds it. It is built with ``nvcc`` at first
launch (``repro_torch.kernels.build``) and bound through a plain C
interface with ``ctypes``, launched on PyTorch's current stream.

``flash_attention_cuda`` takes CUDA tensors only and never falls back to
the plain version (``repro_torch.kernels.ref.flash_attention_ref``); the
device dispatch lives in ``repro_torch.kernels.ops``.
``flash_attention_cuda.launches`` counts its launches, so a run can show
that it went through the kernel. Like the reference kernel it has no
backward: it is a ``torch.autograd.Function`` whose backward raises, so a
gradient through it is never silently dropped.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_design.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.flash_attention_design.restype = ctypes.c_char_p
    return lib


def kernel_design(dtype: torch.dtype, hd: int) -> str:
    """The design the built library dispatches (dtype, hd) to."""
    name = _lib().flash_attention_design(_DTYPES[dtype], hd)
    if name is None:
        raise ValueError(f"no K2 design takes {dtype} at head_dim {hd}")
    return name.decode()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(
            f"flash_attention_cuda needs q, k and v on one CUDA device; got "
            f"{q.device}, {k.device} and {v.device}")
    check_layout(q, k, v, window)


def check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]) -> None:
    """What the kernel takes, short of the device: dtypes, shapes, the
    grid's batch * heads extent and the strides. Raises on anything else;
    the library refuses a sequence with more query tiles than the grid of
    its design holds."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16; "
                        f"got {q.dtype}, {k.dtype} and {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"want q (B, S, H, hd) and k, v (B, S, KV, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV "
                         f"heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel takes "
                         f"{HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if b * h >= 2 ** 31 or s >= 2 ** 31:
        raise ValueError(f"(B, S, H) = ({b}, {s}, {h}) exceeds the kernel's "
                         f"grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim axis must be contiguous")
        # bf16 rows are read 16 bytes at a time, by TMA where the design
        # uses it: every row has to start on a 16-byte boundary
        if t.dtype == torch.bfloat16 and (
                any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16):
            raise ValueError(f"{name}'s rows must start on 16-byte "
                             f"boundaries (strides {t.stride()})")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int]) -> torch.Tensor:
    _check(q, k, v, window)
    b, s, h, hd = q.shape
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, s, h, k.shape[2], hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), 0 if window is None else int(window),
            hd ** -0.5, stream)
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({code})")
    flash_attention_cuda.launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """K2 as an autograd node: forward launches the kernel, backward
    raises (the reference kernel has no backward either)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention_cuda (K2) is forward-only, like the reference "
            "kernel: no backward is ported yet; train with flash=False (see "
            "ROADMAP.md)")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd); all float32 or all bfloat16
    on one CUDA device, head_dim in ``HEAD_DIMS`` and contiguous, H a
    multiple of KV. Returns a contiguous (B, S, H, hd) in q's dtype. Raises
    on anything the kernel does not take, and on a backward through it."""
    return FlashAttention.apply(q, k, v, causal, window)


flash_attention_cuda.launches = 0
