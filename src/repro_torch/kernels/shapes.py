"""The head layouts the CUDA attention kernels take.

Both Pallas kernels of the JAX package take the head dimension whole in
their BlockSpecs, so they run at any ``hd``.  The CUDA kernels hold a
row in 8-element vectors and keep per-row state in registers, which
bounds them: ``hd`` a multiple of 8 from 8 to 256, and a whole number of
query heads for each KV head.  The rule is checked here, by both
wrappers, and again by both C entry points in ``csrc/``.

``prefill_body`` decides which of its three bodies the prefill kernel
takes for a call: the wrapper passes the body's code to the C entry
point, which launches that body or, where it has no instance for the
call, refuses it.  ``packed_body`` decides whether a packed step's
attention takes the packed-row body, which reads the page pool through
the block tables.
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


#: the bodies of the prefill kernel, each on the tensor cores, in the
#: order of the codes the CUDA entry point takes
PREFILL_BODIES = ("tf32", "mma_sync", "wgmma")
#: the one-byte code pools
CODE_DTYPES = ("float8_e4m3fn", "int8")
#: the head dims of the ``mma.sync`` instances
MMA_SYNC_HEAD_DIMS = (32, 64, 128)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def prefill_body(q_dtype, kv_dtype, hd: int, scaled: bool) -> str:
    """The body ``chunked_prefill_attention`` takes for queries of
    ``q_dtype`` over a pool of ``kv_dtype`` (dtypes or their names) at
    head dim ``hd``, with per-token scales or without:

    * ``"wgmma"`` (TMA + ``wgmma``): bf16 queries on a bf16 pool without
      scales, or on fp8 or int8 codes at ``hd % 16 == 0``, at every head
      dim (a row is read as the next width in 64, 128, 192, 256; a tensor
      map needs 16-byte head strides, which one-byte codes have only at
      multiples of 16);
    * ``"mma_sync"``: bf16 queries on an f32 pool or a scaled bf16 pool at
      hd 32, 64 and 128;
    * ``"tf32"`` (3xTF32): every other call, f32 queries included."""
    q, kv = _dtype_name(q_dtype), _dtype_name(kv_dtype)
    if q == "bfloat16":
        if (kv == "bfloat16" and not scaled) or (kv in CODE_DTYPES
                                                 and hd % 16 == 0):
            return "wgmma"
        if kv in ("float32", "bfloat16") and hd in MMA_SYNC_HEAD_DIMS:
            return "mma_sync"
    return "tf32"


#: the widest row the packed-row body takes (instances 64, 128 and 192)
PACKED_MAX_HEAD_DIM = 192
#: MMA rows of the packed-row body's CTA: its query heads a KV head
#: bound them
PACKED_ROWS = 128


def packed_body(q_dtype, kv_dtype, hd: int, H: int, KV: int, page: int,
                scaled: bool) -> bool:
    """Whether the packed-row body of the prefill kernel takes a packed
    step's attention: bf16 queries on an unscaled bf16 pool (the
    ``wgmma`` body's serving path, not its one-byte codes) at ``hd`` up
    to 192, pages of a multiple of 8 tokens (a page's box starts on a
    1024-byte swizzle period) that divide the key tile (128 keys up to
    width 128, 64 at 192), and at most 128 query heads a KV head."""
    if (_dtype_name(q_dtype), _dtype_name(kv_dtype), scaled) != (
            "bfloat16", "bfloat16", False):
        return False
    tile = 128 if hd <= 128 else 64
    return (supported(hd, H, KV) and hd <= PACKED_MAX_HEAD_DIM
            and page % 8 == 0 and tile % page == 0
            and H // KV <= PACKED_ROWS)
