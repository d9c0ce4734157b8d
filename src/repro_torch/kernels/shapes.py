"""The head layouts the CUDA attention kernels take.

Both Pallas kernels of the JAX package take the head dimension whole in
their BlockSpecs, so they run at any ``hd``.  The CUDA kernels hold a
row in 8-element vectors and keep per-row state in registers, which
bounds them: ``hd`` a multiple of 8 from 8 to 256, and a whole number of
query heads for each KV head.  The rule is checked here, by both
wrappers, and again by both C entry points in ``csrc/``.
"""
from __future__ import annotations

#: the widest head row the kernels hold
MAX_HEAD_DIM = 256
RULE = (f"hd % 8 == 0, 8 <= hd <= {MAX_HEAD_DIM}, n_heads % n_kv_heads "
        f"== 0")


def supported(hd: int, H: int, KV: int) -> bool:
    """Whether both CUDA kernels take ``hd`` head dims, ``H`` query
    heads and ``KV`` key/value heads."""
    return (hd % 8 == 0 and 8 <= hd <= MAX_HEAD_DIM and KV > 0 and H > 0
            and H % KV == 0)


def check(hd: int, H: int, KV: int, what: str) -> None:
    """Raise ``ValueError`` naming the rule when ``supported`` is false."""
    if not supported(hd, H, KV):
        raise ValueError(f"{what}: unsupported head layout hd={hd} H={H} "
                         f"KV={KV}; the CUDA kernels take {RULE}")
