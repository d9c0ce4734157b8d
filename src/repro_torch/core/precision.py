"""KV page precision formats and the SLO-class precision policy.

A KV page can be stored at full precision (bf16) or quantized (fp8-e4m3
or int8 codes plus one f32 scale per token row).  Quantized pages cost
half the HBM bytes, which roughly doubles effective pool capacity and
halves alpha->beta handoff stream bytes.

Capacity accounting is denominated in integer **frames** so the
simulator and the engine compare byte budgets exactly (no floats): one
frame is the byte footprint of one *quantized* (1-byte-itemsize) page,
so a bf16 page costs ``BF16.frames == 2`` frames and a quantized page
costs 1.  Under a uniform precision every admission / budget inequality
scales by the same integer factor, so decisions are unchanged; under
mixed precision a quantized request commits half the frames.

Dependency-light on purpose (like :mod:`repro_torch.core.paging`): pure
python, importable from kernels, engine, sim, and core alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.paging import pages_for

#: frames per bf16 page — the bf16/quantized byte ratio (2 bytes / 1 byte)
FRAMES_PER_BF16_PAGE = 2


@dataclasses.dataclass(frozen=True)
class PagePrecision:
    """One KV page storage format.

    ``itemsize`` is the per-element byte width of the stored codes;
    ``qmax`` is the symmetric quantization ceiling (None = unquantized,
    stored verbatim in bf16); ``frames`` is the page's capacity cost in
    1-byte-page units (see module docstring).
    """
    name: str
    itemsize: int
    qmax: Optional[float]
    frames: int

    @property
    def quantized(self) -> bool:
        return self.qmax is not None


BF16 = PagePrecision("bf16", itemsize=2, qmax=None, frames=FRAMES_PER_BF16_PAGE)
FP8 = PagePrecision("fp8", itemsize=1, qmax=448.0, frames=1)   # float8_e4m3fn
INT8 = PagePrecision("int8", itemsize=1, qmax=127.0, frames=1)

PRECISIONS: Dict[str, PagePrecision] = {p.name: p for p in (BF16, FP8, INT8)}

# int8 tag codes for the BlockAllocator's per-page tag array
PRECISION_CODES: Dict[str, int] = {"bf16": 0, "fp8": 1, "int8": 2}
CODE_PRECISIONS: Dict[int, str] = {v: k for k, v in PRECISION_CODES.items()}


def get_precision(p) -> PagePrecision:
    """Coerce a name / PagePrecision / None into a PagePrecision."""
    if p is None:
        return BF16
    if isinstance(p, PagePrecision):
        return p
    try:
        return PRECISIONS[p]
    except KeyError:
        raise ValueError(f"unknown KV precision {p!r}; "
                         f"one of {sorted(PRECISIONS)}") from None


def frames_for(n_tokens: int, page_size: int, precision: PagePrecision) -> int:
    """Frame cost of ``n_tokens`` of KV at ``precision`` (page-rounded)."""
    return pages_for(n_tokens, page_size) * precision.frames


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Maps a request's SLO class to the page format its KV is stored at.

    The paper's classes order naturally by latency tolerance: BATCH
    requests (inf TTFT) take quantized pages for capacity, INTERACTIVE
    keeps bf16 for fidelity, STANDARD is configurable.  ``default``
    covers unclassed requests and unknown names.
    """
    by_class: Dict[str, PagePrecision] = dataclasses.field(
        default_factory=dict)
    default: PagePrecision = BF16

    def for_slo(self, slo_name: Optional[str]) -> PagePrecision:
        if slo_name is None:
            return self.default
        return self.by_class.get(slo_name, self.default)

    @property
    def uniform(self) -> Optional[PagePrecision]:
        """The single precision this policy ever yields, or None."""
        seen = set(self.by_class.values()) | {self.default}
        return next(iter(seen)) if len(seen) == 1 else None

    @staticmethod
    def parse(spec: Optional[str]) -> "PrecisionPolicy":
        """Parse a CLI spec into a policy.

        ``bf16`` / ``fp8`` / ``int8``  -> that precision for everything;
        ``mixed``                      -> batch quantized (fp8), rest bf16;
        ``interactive=bf16,batch=int8[,default=fp8]`` -> explicit map.
        """
        if not spec or spec == "bf16":
            return PrecisionPolicy()
        if spec in PRECISIONS:
            p = PRECISIONS[spec]
            return PrecisionPolicy(default=p)
        if spec == "mixed":
            return PrecisionPolicy(by_class={"batch": FP8}, default=BF16)
        by, default = {}, BF16
        for part in spec.split(","):
            name, _, val = part.partition("=")
            name, val = name.strip(), val.strip()
            prec = get_precision(val or None)
            if name == "default":
                default = prec
            else:
                by[name] = prec
        return PrecisionPolicy(by_class=by, default=default)
