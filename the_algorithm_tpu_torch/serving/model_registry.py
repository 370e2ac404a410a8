"""Versioned model registry with atomic hot-swap.

≡ navi's per-model versioned model-dir scan + atomic reload
(``navi/navi/src/predict_service.rs:25-…`` dir-watcher loop): models live
under ``root/<name>/<version>/params.npz``; a watcher picks up new
numeric version dirs, loads them off-thread, and atomically swaps the
serving pointer. Old versions keep serving in-flight requests.

A host copy of ``the_algorithm_tpu/serving/model_registry.py``, which cannot
be imported without JAX (see ``serving/batcher.py``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from the_algorithm_tpu_torch.core.metrics import NullStats, StatsReceiver

LoadFn = Callable[[str], Any]  # version_dir -> loaded model handle


def save_params_npz(version_dir: str, params: Dict[str, np.ndarray]) -> None:
    """Flat-dict params → npz artifact (the SavedModel-export analog)."""
    os.makedirs(version_dir, exist_ok=True)
    tmp = os.path.join(version_dir, ".params.tmp.npz")  # savez appends .npz
    np.savez(tmp, **params)
    os.replace(tmp, os.path.join(version_dir, "params.npz"))


def load_params_npz(version_dir: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(version_dir, "params.npz")) as z:
        return {k: z[k] for k in z.files}


class ModelRegistry:
    """Scans ``root/<model>/<int version>/``; serves the highest version."""

    def __init__(
        self,
        root: str,
        load_fn: LoadFn = load_params_npz,
        poll_interval_s: float = 1.0,
        stats: Optional[StatsReceiver] = None,
    ):
        self.root = root
        self.load_fn = load_fn
        self.poll_interval_s = poll_interval_s
        self.stats = stats or NullStats()
        self._lock = threading.Lock()
        self._serving: Dict[str, Tuple[int, Any]] = {}
        self._shutdown = threading.Event()
        self._watcher: Optional[threading.Thread] = None

    # -- queries -------------------------------------------------------------

    def get(self, model: str) -> Any:
        with self._lock:
            if model not in self._serving:
                raise KeyError(f"model '{model}' not loaded")
            return self._serving[model][1]

    def version(self, model: str) -> int:
        with self._lock:
            return self._serving[model][0]

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._serving)

    # -- scanning ------------------------------------------------------------

    def _list_versions(self, model: str) -> List[int]:
        d = os.path.join(self.root, model)
        if not os.path.isdir(d):
            return []
        out = []
        for v in os.listdir(d):
            if v.isdigit() and os.path.isdir(os.path.join(d, v)):
                out.append(int(v))
        return sorted(out)

    def scan_once(self) -> List[str]:
        """One reload pass; returns models whose version changed."""
        changed = []
        if not os.path.isdir(self.root):
            return changed
        for model in sorted(os.listdir(self.root)):
            versions = self._list_versions(model)
            if not versions:
                continue
            latest = versions[-1]
            with self._lock:
                current = self._serving.get(model, (None, None))[0]
            if current == latest:
                continue
            # load outside the lock (slow), swap atomically
            handle = self.load_fn(os.path.join(self.root, model, str(latest)))
            with self._lock:
                self._serving[model] = (latest, handle)
            self.stats.counter(f"registry/{model}/reloads")
            changed.append(model)
        return changed

    def start_watcher(self) -> None:
        if self._watcher is not None:
            return

        def loop():
            while not self._shutdown.is_set():
                try:
                    self.scan_once()
                except Exception:
                    self.stats.counter("registry/scan_failures")
                self._shutdown.wait(self.poll_interval_s)

        self._watcher = threading.Thread(target=loop, daemon=True)
        self._watcher.start()

    def close(self) -> None:
        self._shutdown.set()
        if self._watcher:
            self._watcher.join(timeout=2.0)
