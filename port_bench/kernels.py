"""Which layer a device kernel of the trace belongs to, by its name.

- ``flash_fwd`` / ``flash_bwd``: the port's flash kernels
  (``csrc/flash_fwd.cu``'s ``flash_fwd_*kernel``, ``csrc/flash_bwd.cu``'s
  ``flash_bwd_dq_*kernel`` and ``flash_bwd_dkv_*kernel``);
- ``gemm``: cuBLAS's and CUTLASS's matrix products (``gemm``, ``cutlass``,
  ``xmma``, ``nvjet``, ``cublas`` in the name);
- ``other``: everything else (elementwise, norms, casts, reductions,
  indexing, the loss's and the optimizer's kernels).
"""

from __future__ import annotations

import re

_FLASH_FWD = re.compile(r"\bflash_fwd_\w*kernel")
_FLASH_BWD = re.compile(r"\bflash_bwd_(dq|dkv)_\w*kernel")
_GEMM_TAGS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")


def classify(name: str) -> str:
    if _FLASH_FWD.search(name):
        return "flash_fwd"
    if _FLASH_BWD.search(name):
        return "flash_bwd"
    lower = name.lower()
    if any(tag in lower for tag in _GEMM_TAGS):
        return "gemm"
    return "other"


def short(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and arguments."""
    name = name.removeprefix("void ")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:limit]
