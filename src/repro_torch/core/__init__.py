"""BucketServe core (copied from the reference package; no JAX in any of it)."""
from .request import Request, TaskType                      # noqa: F401
from .bucket import Bucket, BucketManager                   # noqa: F401
from .batcher import (DynamicBatchController, FormedBatch,  # noqa: F401
                      MemoryBudget)
from .scheduler import (BucketServeScheduler,               # noqa: F401
                        GoodputScheduler, SchedulerBase, SchedulerConfig)
from .monitor import GlobalMonitor                          # noqa: F401
from .paging import BlockAllocator                          # noqa: F401
from .prefix_cache import PrefixCache, PrefixStats          # noqa: F401
from .retention import KvRetention, RetentionStats          # noqa: F401
from .serving_loop import (Clock, ExecutionBackend,         # noqa: F401
                           LoopConfig, PrefillJob, ServeResult,
                           ServingLoop, VirtualClock, WallClock)
