"""Generic ANN library: a typed index API, brute-force and clustered-scan
indexes on the device, the host HNSW engine and the loadtest harness."""

from the_algorithm_tpu_torch.ann_lib.index import (  # noqa: F401
    BruteForceIndex,
    ClusteredScanIndex,
    Metric,
)
from the_algorithm_tpu_torch.ann_lib.loadtest import LoadTestRecorder, run_loadtest  # noqa: F401
