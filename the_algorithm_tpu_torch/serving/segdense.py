"""Segdense: spec-driven request→tensor densification on the serve path.

≡ ``navi/segdense/src/mapper.rs`` + ``navi/dr_transform/src/converter.rs``
(SURVEY.md §2.2): navi loads a JSON slot spec mapping named features to
tensor columns and densifies each inference request's sparse DataRecord into
the model's input tensor in native code. Here the spec binds flat column
names (the home-mixer wide schema or any FeatureSpec list) to murmur3
feature ids, and :class:`RequestDensifier` runs incoming sparse records
through the C++ TRec codec + vocab densifier
(``native/src/tpurecsys.cc:tpurecsys_densify``) into the model's [B, F]
matrix in schema order — no Python loop over features on the hot path.

The spec JSON round-trips (``save``/``load``) so the serving front and the
training exporter share one artifact (the segdense file navi ships beside
each model version).

A host copy of ``the_algorithm_tpu/serving/segdense.py`` over the port's
copy of the native codec; the densified matrix is the JAX package's, bit for
bit. String keys are hashed in Python, one ``feature_id`` a key, as there:
clients that send precomputed ids skip it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from the_algorithm_tpu_torch import native
from the_algorithm_tpu_torch.core.hashing import feature_id
from the_algorithm_tpu_torch.mixers import feature_schema as fs


@dataclasses.dataclass(frozen=True)
class SegdenseSpec:
    """Column-name → slot binding (the segdense JSON)."""

    feature_names: Tuple[str, ...]  # model input order, flat (F columns)
    label_names: Tuple[str, ...] = ()

    @property
    def width(self) -> int:
        return len(self.feature_names)

    def feature_ids(self) -> np.ndarray:
        return np.asarray([feature_id(n) for n in self.feature_names],
                          np.int64)

    def label_ids(self) -> np.ndarray:
        return np.asarray([feature_id(n) for n in self.label_names], np.int64)

    # -- artifact round-trip (shipped beside the model version) --------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"features": list(self.feature_names),
                 "labels": list(self.label_names)},
                f, separators=(",", ":"),
            )

    @classmethod
    def load(cls, path: str) -> "SegdenseSpec":
        with open(path) as f:
            d = json.load(f)
        return cls(tuple(d["features"]), tuple(d.get("labels", ())))


def spec_from_schema(schema, label_names: Sequence[str] = ()) -> SegdenseSpec:
    """Bind a FeatureSpec list (e.g. ``feature_schema.WIDE_SCHEMA``) —
    vector features expand to ``name_i`` columns exactly as the columnar
    assembler orders them."""
    return SegdenseSpec(tuple(fs.expand(schema)), tuple(label_names))


class RequestDensifier:
    """Sparse request records → [B, F] model input (native hot path).

    Requests arrive as ``{name_or_id: value}`` maps (the thrift BPR
    adapter's output shape); densification is one C++ call over the packed
    block. Ids may be precomputed by clients (``feature_id(name)``) to skip
    host hashing entirely.
    """

    def __init__(self, spec: SegdenseSpec):
        self.spec = spec
        ids = spec.feature_ids()
        order = np.argsort(ids, kind="stable")
        self._sorted_ids = ids[order]  # densify wants ascending vocab
        self._unsort = np.empty_like(order)
        self._unsort[order] = np.arange(order.shape[0])
        if len(set(self._sorted_ids.tolist())) != ids.shape[0]:
            raise ValueError("feature-id hash collision in spec")
        lids = spec.label_ids()
        lorder = np.argsort(lids, kind="stable")
        self._sorted_lids = lids[lorder]
        self._lunsort = np.empty_like(lorder)
        self._lunsort[lorder] = np.arange(lorder.shape[0])

    def _record(self, rec: Mapping) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for k, v in rec.items():
            fid = feature_id(k) if isinstance(k, str) else int(k)
            out[fid] = float(v)
        return out

    def densify(
        self, records: Sequence[Mapping]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (values [B, F] float32 in spec order, mask [B, F] uint8)."""
        block = native.encode_block([(self._record(r), {}) for r in records])
        values, mask = native.densify(block, self._sorted_ids)
        return values[:, self._unsort], mask[:, self._unsort]

    def densify_with_labels(
        self, records: Sequence[Tuple[Mapping, Mapping]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Training-example form → (features [B, F], labels [B, L])."""
        block = native.encode_block(
            [(self._record(f), self._record(l)) for f, l in records]
        )
        values, _ = native.densify(block, self._sorted_ids)
        labels, _ = native.densify_labels(block, self._sorted_lids)
        return values[:, self._unsort], labels[:, self._lunsort]
