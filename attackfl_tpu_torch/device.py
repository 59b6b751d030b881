"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device they raise instead of carrying on elsewhere.

:data:`CAPTURE_LOCK` serialises a CUDA graph's capture against the
device-wide syncs of other threads.  The run service's jobs are threads
of one process on one card: a ``torch.cuda.synchronize`` in a run job's
thread while a matrix job captures its step graph fails the run job and
invalidates the capture (both jobs crashed, once, on the H100).  The
capture (``training/local.StepGraph``) and a profiling window's stop,
which waits for the card, hold it; every device-wide sync of the port
goes through :func:`synchronize`, which holds it too.
"""

from __future__ import annotations

import threading

import torch

CAPTURE_LOCK = threading.Lock()


def synchronize(device: str | torch.device = "cuda") -> None:
    """Wait for every stream of ``device`` under :data:`CAPTURE_LOCK`, so
    no other thread's graph capture is under way; nothing on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    with CAPTURE_LOCK:
        torch.cuda.synchronize(dev)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Validate ``device`` and pin the math to the JAX package's.

    TF32 is switched off for matmuls and cuDNN: it keeps about three
    decimal digits, and every parity tolerance of the port is a float32
    tolerance.  The reduced-precision reductions of bfloat16 and float16
    GEMMs are switched off too: XLA accumulates those products in
    float32, and so cuBLAS does with these flags off."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' (or "
                "--device cpu) to run the plain-PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    return dev
