"""Parallelism: row-sharded tables, collective lookups, distributed top-K."""

from the_algorithm_tpu_torch.parallel.sharded_table import (  # noqa: F401
    ShardedTable,
    lookup,
    lookup_onehot_psum,
    scatter_add,
)
from the_algorithm_tpu_torch.parallel.distributed_topk import sharded_topk  # noqa: F401
