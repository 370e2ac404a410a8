"""DataRecordTrainer: TRec files → calibrate → train → export.

Counterpart of ``the_algorithm_tpu/training/data_record_trainer.py`` ≡
``twml.trainers.DataRecordTrainer`` (``twml/twml/trainers/
data_record_trainer.py:72`` — input fn :533, ``calibrate``:775) and its
three-phase light-ranker flow (``deepbird/.../earlybird/train.py:39-118``):

  1. **calibrate** — stream a sample of TRec blocks, fit per-feature
     percentile bins (host-side, ≡ ``common_calibrators.py:265``);
  2. **train** — stream deterministic per-host batches (C++ block decode +
     bit-identical hashing, :mod:`the_algorithm_tpu_torch.data.datarecord`)
     into the :class:`~the_algorithm_tpu_torch.training.trainer.Trainer`, on
     one device or, given a mesh and partition rules, data-parallel over it;
  3. **export** — write the params + calibration artifact into a
     ``serving.model_registry`` version dir (SavedModel-export analog),
     closing the train→serve loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
from torch import nn

from the_algorithm_tpu_torch import native
from the_algorithm_tpu_torch.data import datarecord
from the_algorithm_tpu_torch.ops import discretizer as disc
from the_algorithm_tpu_torch.training.trainer import Trainer, TrainerConfig


def calibrate_from_files(
    dataset: datarecord.TRecDataset,
    feature_vocab: np.ndarray,  # sorted int64 [F]
    n_bins: int,
    output_bits: int,
    *,
    max_records: int = 50_000,
) -> disc.HashingDiscretizer:
    """Phase 1: fit percentile bins from a streamed calibration sample.

    ≡ ``calibrate_discretizer_and_export`` (common_calibrators.py:537) —
    accumulate up to ``max_records`` present values per feature, then fit
    equal-mass boundaries.
    """
    samples: Dict[int, list] = {int(f): [] for f in feature_vocab}
    seen = 0
    for block in dataset.blocks(num_epochs=1):
        values, mask = native.densify(block, feature_vocab)
        for i, fid in enumerate(feature_vocab):
            col = values[:, i][mask[:, i]]
            if col.size:
                samples[int(fid)].append(col)
        seen += values.shape[0]
        if seen >= max_records:
            break
    merged = {
        f: (np.concatenate(v) if v else np.zeros(0, np.float32))
        for f, v in samples.items()
    }
    bins = disc.fit_percentile_bins(merged, n_bins)
    return disc.HashingDiscretizer(bins, output_bits)


@dataclasses.dataclass
class DataRecordTrainerConfig:
    batch_size: int = 1024
    n_bins: int = 16
    output_bits: int = 18
    max_calibration_records: int = 50_000
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)


class DataRecordTrainer:
    """The file-fed trainer: owns a Trainer + a transform + the export path.

    ``batch_fn`` adapts the raw per-batch numpy dict into whatever the
    loss_fn consumes (e.g. build a ``hashed_lr.SparseBatch`` of numpy
    arrays); it runs on host, once per batch, and the Trainer puts the result
    on its device. Trains on the card unless given a ``device``; with
    ``mesh`` and ``partition_rules`` (the JAX signature's, here optional)
    over the mesh, every rank reading the same files and keeping its block
    of each batch.
    """

    def __init__(
        self,
        loss_fn,
        model: nn.Module,
        transform: datarecord.Transform,
        batch_fn: Callable[[Dict[str, np.ndarray]], Any],
        config: DataRecordTrainerConfig = DataRecordTrainerConfig(),
        stats=None,
        device=None,
        mesh=None,
        partition_rules=None,
    ):
        self.config = config
        self.transform = transform
        self.batch_fn = batch_fn
        self.trainer = Trainer(loss_fn, model, config=config.trainer, stats=stats, device=device, mesh=mesh,
                               partition_rules=partition_rules)

    def input_batches(
        self, dataset: datarecord.TRecDataset,
        num_epochs: Optional[int] = None,
    ) -> Iterator[Any]:
        """≡ ``get_train_input_fn`` (data_record_trainer.py:533)."""
        for raw in dataset.batches(
            self.config.batch_size, self.transform, num_epochs=num_epochs
        ):
            yield self.batch_fn(raw)

    def fit_from_files(
        self,
        dataset: datarecord.TRecDataset,
        num_steps: int,
        *,
        eval_fn=None,
        eval_every: Optional[int] = None,
    ) -> Dict[str, float]:
        return self.trainer.fit(
            self.input_batches(dataset), num_steps,
            eval_fn=eval_fn, eval_every=eval_every,
        )

    @property
    def params(self) -> nn.Module:
        return self.trainer.model

    def export(
        self, version_dir: str, extra: Optional[Dict[str, Any]] = None
    ):
        """Phase 3: registry-loadable artifact (params + calibration)."""
        return self.trainer.export(version_dir, extra=extra)
