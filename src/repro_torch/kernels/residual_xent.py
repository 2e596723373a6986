"""K1 on Hopper: r = onehot(labels) - softmax(logits), CUDA C++ for sm_90a.

Replaces ``src/repro/kernels/residual_xent.py:residual_xent_kernel`` (two
Pallas passes over (128, 512) tiles). The kernel is
``csrc/residual_xent.cu``: one thread block per token row, an online
(max, sumexp) pass and a residual pass; its header says what bounds it.
It is built with ``nvcc`` at first launch (``repro_torch.kernels.build``)
and bound through a plain C interface with ``ctypes``, launched on
PyTorch's current stream.

``residual_xent_cuda`` takes CUDA tensors only and never falls back to the
plain version (``repro_torch.kernels.ref.residual_xent_ref``); the device
dispatch lives in ``repro_torch.kernels.ops``. ``residual_xent_cuda.launches``
counts its launches, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("residual_xent")
    fn = lib.residual_xent_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.residual_xent_error_string.argtypes = [ctypes.c_int]
        lib.residual_xent_error_string.restype = ctypes.c_char_p
    return lib


def residual_xent_cuda(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """logits: (T, V) f32 or bf16 on a CUDA device, contiguous; labels:
    (T,) integer on the same device (int64 is cast to int32). Returns the
    (T, V) f32 residual. Raises on anything the kernel does not take."""
    if logits.device.type != "cuda" or labels.device != logits.device:
        raise ValueError(
            f"residual_xent_cuda needs logits and labels on one CUDA device; "
            f"got {logits.device} and {labels.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if logits.ndim != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"want logits (T, V) and labels (T,); got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    t, v = logits.shape
    if t >= 2 ** 31:
        raise ValueError(f"{t} rows exceed the kernel's grid")
    labels = labels.to(torch.int32).contiguous()
    out = torch.empty((t, v), dtype=torch.float32, device=logits.device)
    if t == 0 or v == 0:
        return out
    lib = _lib()
    vec = int(logits.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        code = lib.residual_xent_launch(
            logits.data_ptr(), _DTYPES[logits.dtype], labels.data_ptr(),
            out.data_ptr(), t, v, vec, stream)
    if code != 0:
        msg = lib.residual_xent_error_string(code).decode()
        raise RuntimeError(f"residual_xent launch failed: {msg} ({code})")
    residual_xent_cuda.launches += 1
    return out


residual_xent_cuda.launches = 0
