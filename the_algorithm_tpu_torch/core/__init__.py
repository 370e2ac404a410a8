"""Core runtime: mesh/topology, partition rules, config, hashing, metrics.

Re-exports what the JAX package's ``core/__init__.py`` does, less
``named_sharding`` and ``with_sharding_constraint``, which have no
counterpart (``core/partition.py``).
"""

from the_algorithm_tpu_torch.core.mesh import (  # noqa: F401
    MeshSpec,
    make_mesh,
    get_mesh,
    set_mesh,
    local_mesh,
)
from the_algorithm_tpu_torch.core.partition import match_partition_rules  # noqa: F401
from the_algorithm_tpu_torch.core.config import Param, Params, param_scope  # noqa: F401
from the_algorithm_tpu_torch.core.metrics import StatsReceiver, NullStats  # noqa: F401
