"""Serving warmup: drive every (model, batch-bucket) before traffic.

≡ the reference's warmup handlers — ``simclustersann/SimclustersAnnWarmup
Handler.scala``, GFS ``ServerWarmupHandler.scala``, pushservice
``PushMixerThriftServerWarmupHandler.scala`` — which fire synthetic requests
until the JVM/JIT is hot. On the GPU the first request pays the first-use
costs: cuBLAS handles and workspaces, the caching allocator's growth to the
bucket's size, and, where the predict path launches a hand-written kernel,
its ``nvcc`` build. Warmup runs one dummy batch per bucket per model through
the real predict path and blocks readiness until all of them have run.

The port of ``the_algorithm_tpu/serving/warmup.py``. A bucket blocks on the
device's work before its clock stops: a tensor output is copied to the host
(``np.asarray`` raises on a CUDA tensor), so a bucket's seconds hold the
device time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from the_algorithm_tpu_torch.core.device import host_array


@dataclasses.dataclass(frozen=True)
class WarmupSpec:
    """One model's warmup plan: input maker per batch bucket."""

    model_name: str
    predict_fn: Callable[[np.ndarray], np.ndarray]
    make_input: Callable[[int], np.ndarray]  # batch_size -> [B, ...] input
    batch_buckets: Sequence[int] = (1, 8, 64, 256)


@dataclasses.dataclass
class WarmupReport:
    model_name: str
    bucket_seconds: Dict[int, float]
    ok: bool
    error: Optional[str] = None

    @property
    def total_seconds(self) -> float:
        return sum(self.bucket_seconds.values())


def run_warmup(
    specs: Sequence[WarmupSpec],
    *,
    repeats: int = 2,
    stats=None,
) -> List[WarmupReport]:
    """Drive every (model, bucket) ``repeats`` times (the first pays the
    first-use costs, the second confirms the steady state). Returns
    per-model reports; a server should gate its readiness endpoint on ``all(r.ok)``."""
    reports: List[WarmupReport] = []
    for spec in specs:
        buckets: Dict[int, float] = {}
        err: Optional[str] = None
        for b in spec.batch_buckets:
            t0 = time.monotonic()
            try:
                x = spec.make_input(b)
                for _ in range(repeats):
                    out = spec.predict_fn(x)
                host_array(out)  # block until the device finishes
            except Exception as e:  # fail-closed: not ready
                err = f"bucket {b}: {type(e).__name__}: {e}"
                break
            buckets[b] = time.monotonic() - t0
        report = WarmupReport(
            model_name=spec.model_name, bucket_seconds=buckets,
            ok=err is None, error=err,
        )
        if stats is not None:
            scope = f"warmup/{spec.model_name}"
            stats.counter(f"{scope}/ok" if report.ok else f"{scope}/failed")
        reports.append(report)
    return reports


def registry_warmup_specs(
    registry,
    predict_builder: Callable[[str, Mapping], Callable[[np.ndarray], np.ndarray]],
    input_makers: Mapping[str, Callable[[int], np.ndarray]],
    batch_buckets: Sequence[int] = (1, 8, 64, 256),
) -> List[WarmupSpec]:
    """Build specs for every model currently in a ``ModelRegistry``
    (``predict_builder(name, params)`` runs once per model, on the version
    the registry holds now)."""
    specs = []
    for name in registry.models():
        params = registry.get(name)
        specs.append(WarmupSpec(
            model_name=name,
            predict_fn=predict_builder(name, params),
            make_input=input_makers[name],
            batch_buckets=batch_buckets,
        ))
    return specs
