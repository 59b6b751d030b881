"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device they raise instead of carrying on elsewhere.
"""

from __future__ import annotations

import torch


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
