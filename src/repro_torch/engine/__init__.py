from repro_torch.engine.block_allocator import (  # noqa: F401
    BlockAllocator, CapacityError, OutOfPages, pages_for,
)
from repro_torch.engine.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.engine.runner import InstanceEngine, BatchItem  # noqa: F401
from repro_torch.engine.backend import EngineBackend, H100  # noqa: F401
