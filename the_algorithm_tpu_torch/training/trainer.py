"""The training loop: eval, best step, early stopping, checkpoints, export;
on one device or over a (data, model) mesh with the JAX package's partition
rules.

Counterpart of ``the_algorithm_tpu/training/trainer.py`` ≡ twml's Estimator
wrapper (``twml/twml/trainers/trainer.py:131`` — checkpointing :150-413,
``learn``:946, ``train_and_evaluate``:1194). The JAX package's step is a
donated ``jit`` over a mesh; here it is eager PyTorch, the parameters an
``nn.Module`` and the optimizer one of
:mod:`~the_algorithm_tpu_torch.training.optimizers` updating them in place.

Without a mesh the step runs on one device. With one (``core/mesh.py``:
one process a device, every rank of the mesh running the same loop), the
JAX ``Trainer``'s synchronous data parallelism with sharded parameters:

  - params are placed by ``partition_rules`` (``core/partition.py``: the
    JAX rules, matched on the JAX names): each rank keeps its blocks, and
    the optimizer's state is sharded like them;
  - each rank steps on its block of the global batch, split over the
    model's batch axes (``partition.batch_axes_of``: ('data',), or the joint
    ('data', 'model') for an explicit row exchange); ``loss_fn`` returns the
    mean over that block (a whole-batch loss gathers what it needs itself,
    ``partition.batch_split``), and the step's loss is their mean over the
    ranks: the global batch's;
  - **the gradient rule**: each parameter's gradient is summed over the mesh
    axes that split the batch where that parameter is used, and over none
    of the axes that shard the parameter itself, then divided by the number
    of batch blocks (the mean of the blocks' means). So replicated tower
    weights behind the explicit row exchange sum over both axes; tables
    (their rows already routed to their owners within 'model') over
    'data'; replicated MaskNet weights over 'data' only, because the model
    ranks repeat the same batch. Work repeated on every 'model' rank is
    never summed over 'model' (``torch.distributed.nn.functional.
    all_reduce``'s backward would): the collectives under autograd
    (``core/mesh.gather_rows``, ``gather_columns``, ``sum_grad``) state
    their transposes. The sums are bucketed: one flat buffer for each set of
    axes, one all-reduce an axis longer than one rank.

Checkpoints are the port's own format: ``torch.save`` of the model's and
the optimizer's ``state_dict`` in one file per step directory
(``<checkpoint_dir>/<step>/state.pt``; on a mesh each rank's blocks in
``state.<rank>.pt``, rank its position in the mesh, with the mesh's shape
and each parameter's spec), the newest ``keep_checkpoints`` kept.
``restore`` loads a checkpoint saved on one device or on a mesh of any
shape into this Trainer's layout, as JAX's orbax ``StandardRestore`` does:
each rank reads, from the files whose blocks cover its own, the parameter
blocks, the optimizer state sharded like them (Adam's moments in their own
type, the int32 count) and the step, bit for bit. A file without specs (as
written before they were recorded) is laid out by this Trainer's rules.
:meth:`Trainer.export` writes the flat-dict npz the JAX Trainer writes for
the same model: the same names, shapes and layouts, from the global arrays
(on a mesh the first rank writes it).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from the_algorithm_tpu_torch.core import partition
from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.core.mesh import JOINT_AXES, Mesh, local_mesh
from the_algorithm_tpu_torch.core.metrics import NullStats, StatsReceiver
from the_algorithm_tpu_torch.training import optimizers

LossFn = Callable[[nn.Module, Any], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
# loss_fn(model, batch) -> (loss, aux_metrics)


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # adam | adagrad | sgd
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3  # ≡ keep_checkpoint_max (trainer.py:150-413)
    log_every: int = 100
    checkpoint_every: int = 1000  # ≡ save_checkpoints_steps (configurable)
    # best-checkpoint selection ≡ best_or_latest_checkpoint
    # (twml/twml/trainers/trainer.py:644-659): track this eval metric and
    # remember the step where it was best.
    eval_metric: Optional[str] = None
    metric_larger_is_better: bool = True
    # stop fit() after this many evals without improvement (None = never)
    early_stopping_patience: Optional[int] = None


def make_optimizer(config: TrainerConfig, params) -> torch.optim.Optimizer:
    """The JAX package's optax chain over ``params``, with optax's math:
    ``adam`` ≡ ``optax.adamw(lr, weight_decay=config.weight_decay)``,
    ``adagrad`` ≡ ``optax.adagrad``, ``sgd`` ≡ ``optax.sgd``, each behind
    ``optax.clip_by_global_norm(max_grad_norm)`` when that is set."""
    clip = config.max_grad_norm or None
    if config.optimizer == "adam":
        return optimizers.Adam(params, config.learning_rate, weight_decay=config.weight_decay, max_grad_norm=clip)
    if config.optimizer == "adagrad":
        return optimizers.Adagrad(params, config.learning_rate, max_grad_norm=clip)
    if config.optimizer == "sgd":
        return optimizers.SGD(params, config.learning_rate, max_grad_norm=clip)
    raise ValueError(f"unknown optimizer {config.optimizer}")


def put_batch(batch: Any, device: torch.device) -> Any:
    """A host batch (numpy arrays or tensors, in dicts, lists, tuples and
    NamedTuples) with every array on ``device``; on the card the copies are
    asynchronous from pinned memory."""
    cuda = device.type == "cuda"

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor):
            if x.device == device:
                return x
            if cuda and x.device.type == "cpu":
                return x.pin_memory().to(device, non_blocking=True)
            return x.to(device)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):  # NamedTuple
            return type(x)(*(put(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return x

    return put(batch)


def _tensors(x: Any):
    """Every tensor of a batch put by :func:`put_batch`."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _host_block(x, index: int, n: int):
    """Block ``index`` of ``n`` along dim 0 of every array of a batch
    (numpy or tensors, in dicts, lists, tuples and NamedTuples)."""
    if isinstance(x, (np.ndarray, torch.Tensor)):
        if x.shape[0] % n:
            raise ValueError(f"batch={x.shape[0]} not divisible by {n} blocks")
        per = x.shape[0] // n
        return x[index * per:(index + 1) * per]
    if isinstance(x, dict):
        return {k: _host_block(v, index, n) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host_block(v, index, n) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_host_block(v, index, n) for v in x)
    return x


class Trainer:
    """``loss_fn(model, batch) -> (loss, aux)`` differentiated by autograd,
    the optimizer of ``config`` (:func:`make_optimizer`), batches put on the
    model's device.

    Without ``mesh``: one device, the card unless given a ``device``. With
    ``mesh`` (the JAX signature's mesh and ``partition_rules``): ``model``
    holds the global params, and each rank keeps its blocks under the rules
    on ``mesh.device`` (see the module's docstring). ``local_batches``: the
    batches a rank passes are already its block (JAX's multi-process
    ``make_array_from_process_local_data`` path; ranks sharing a batch block
    pass the same rows), not the global batch.
    """

    def __init__(
        self,
        loss_fn: LossFn,
        model: nn.Module,
        config: TrainerConfig = TrainerConfig(),
        stats: Optional[StatsReceiver] = None,
        device=None,
        mesh: Optional[Mesh] = None,
        partition_rules: Optional[partition.PartitionRules] = None,
        local_batches: bool = False,
    ):
        self.loss_fn = loss_fn
        self.config = config
        self.stats = stats or NullStats()
        self.mesh = mesh
        self.local_batches = local_batches
        self._global_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        if mesh is None:
            self.device = resolve(device, "Trainer")
            self.model = model.to(self.device)
        else:
            self.device = mesh.device
            self.model = model
            self.specs = partition.shard_module(model, mesh, partition_rules or [(".*", partition.P())])
            self.batch_axes = partition.batch_axes_of(model)
            self.blocks = mesh.size(self.batch_axes)  # the batch blocks a step's loss averages
            self._sum_axes = {}  # each param's gradient: the batch's axes that do not shard it
            split = {}
            for name, p in model.named_parameters():
                own = partition.spec_axes(self.specs[name])  # a tuple: every rank takes the axes in one order
                self._sum_axes[name] = tuple(a for a in self.batch_axes if a not in own and mesh.shape[a] > 1)
                split[p] = tuple(a for a in own if mesh.shape[a] > 1)
        self.optimizer = make_optimizer(config, self.model.parameters())
        if mesh is not None:
            self.optimizer.split_over(mesh, split)
        self.step = 0
        self.best_step: Optional[int] = None
        self.best_metric: Optional[float] = None

    def shard_batch(self, batch: Any) -> Any:
        """A host batch on this trainer's device: on a mesh, this rank's
        block over the batch's axes (the global batch given, unless
        ``local_batches``)."""
        if self.mesh is not None and not self.local_batches:
            batch = _host_block(batch, self.mesh.position(self.batch_axes), self.blocks)
        return put_batch(batch, self.device)

    def train_step(self, batch: Any) -> Dict[str, torch.Tensor]:
        """One step on a host or device batch; returns aux with ``loss``
        (device tensors: reading one waits for the step). On a mesh every
        rank calls it with the same global batch (or its own block, with
        ``local_batches``); the loss and aux are the global batch's."""
        return self._step(self.shard_batch(batch))

    def _step(self, batch: Any) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad(set_to_none=True)
        if self.mesh is None:
            loss, aux = self.loss_fn(self.model, batch)
        else:
            with local_mesh(self.mesh), partition.batch_split(self.mesh, self.batch_axes):
                loss, aux = self.loss_fn(self.model, batch)
        loss.backward()
        if self.mesh is not None:
            self._reduce_grads()
        self.optimizer.step()
        aux = dict(aux)
        aux["loss"] = loss.detach()
        if self.mesh is not None and self.blocks > 1:
            aux = self._batch_mean(aux)
        self.step += 1
        if self.step % self.config.log_every == 0:
            for k, v in aux.items():
                self.stats.stat(f"train/{k}", float(v))
        return aux

    def _reduce_grads(self) -> None:
        """The gradient rule: each gradient summed over its axes (one flat
        buffer an axis set and dtype), then all divided by the blocks."""
        buckets: Dict[Tuple, list] = {}
        grads = []
        for name, p in self.model.named_parameters():
            if p.grad is None:
                continue
            grads.append(p.grad)
            if self._sum_axes[name]:
                buckets.setdefault((self._sum_axes[name], p.grad.dtype), []).append(p.grad)
        for (axes, _), gs in buckets.items():
            flat = torch.cat([g.reshape(-1) for g in gs])
            self.mesh.all_reduce_(flat, axes)
            torch._foreach_copy_(gs, [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in gs]), gs)])
        if self.blocks > 1:
            torch._foreach_mul_(grads, 1.0 / self.blocks)

    def _batch_mean(self, aux: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Each scalar of ``aux`` averaged over the batch blocks (one all-reduce)."""
        keys = list(aux)
        vals = torch.stack([torch.as_tensor(aux[k], dtype=torch.float32, device=self.device).reshape(())
                            for k in keys])
        vals = self.mesh.all_reduce_(vals, self.batch_axes) / self.blocks
        return dict(zip(keys, vals.unbind()))

    def _eval(self, eval_fn, model) -> Dict[str, float]:
        """``eval_fn`` on every rank (under the mesh); on a mesh the first
        rank's metrics, so every rank takes the same best-step and
        early-stopping turns."""
        if self.mesh is None:
            return eval_fn(model)
        with local_mesh(self.mesh):
            ev = eval_fn(model)
        keys = sorted(ev)
        vals = self.mesh.from_first(torch.tensor([float(ev[k]) for k in keys], dtype=torch.float64,
                                                 device=self.device))
        return dict(zip(keys, vals.tolist()))

    def _prefetch(self, batches: Iterator[Any], depth: int) -> Iterator[Any]:
        """Overlapped host→device input feed: a feeder thread parses the next
        batches, takes this rank's block on a mesh (:meth:`shard_batch`) and
        copies them to the device while the current step runs — the tf.data
        input overlap of twml's DataRecordTrainer
        (``data_record_trainer.py:533``). On the card the copies run on the
        feeder's own stream; the step's stream waits for each batch's copy
        and records its use of the batch's memory. A feeder error is raised
        in the loop. When the loop ends, it waits for the feeder to stop (it
        finishes the batch in hand): a thread left in a torch call when the
        process exits aborts it."""
        q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        sentinel = object()
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():  # the loop may have ended: never block for good
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def feeder():
            try:
                for b in batches:
                    if cuda:
                        with torch.cuda.stream(stream):
                            b = self.shard_batch(b)
                            done = torch.cuda.Event()
                            done.record(stream)
                    else:
                        done = None
                        b = self.shard_batch(b)
                    if not put((b, done)):
                        return
                put(sentinel)
            except BaseException as e:  # surface feeder errors in-loop
                put((sentinel, e))

        thread = threading.Thread(target=feeder, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if item[0] is sentinel:
                    raise item[1]
                b, done = item
                if done is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(done)
                    for t in _tensors(b):
                        t.record_stream(current)
                yield b
        finally:
            stop.set()
            thread.join()

    def fit(
        self,
        batches: Iterator[Any],
        num_steps: int,
        eval_fn: Optional[Callable[[nn.Module], Dict[str, float]]] = None,
        eval_every: Optional[int] = None,
        prefetch: int = 2,
    ) -> Dict[str, float]:
        """≡ ``Trainer.learn`` / ``train_and_evaluate`` (trainer.py:946,1194).

        When ``config.eval_metric`` is set, each eval updates the
        best-step/best-metric bookkeeping (and checkpoints improvements);
        ``early_stopping_patience`` evals without improvement end the loop.
        ``prefetch`` > 0 overlaps input parsing and the host→device copy
        with the step (0 feeds synchronously). On a mesh ``eval_fn`` runs on
        every rank and the first rank's metrics count.
        """
        cfg = self.config
        last: Dict[str, Any] = {}
        stale_evals = 0
        batches = iter(batches)
        if prefetch:
            batches = self._prefetch(batches, prefetch)
        step = self._step if prefetch else self.train_step  # prefetched batches are placed already
        try:
            for _ in range(num_steps):
                batch = next(batches)
                last = step(batch)
                if eval_fn is not None and eval_every and self.step % eval_every == 0:
                    ev = self._eval(eval_fn, self.model)
                    last.update(ev)
                    for k, v in ev.items():
                        self.stats.stat(f"eval/{k}", float(v))
                    if cfg.eval_metric is not None and cfg.eval_metric in ev:
                        m = float(ev[cfg.eval_metric])
                        better = self.best_metric is None or (
                            m > self.best_metric if cfg.metric_larger_is_better else m < self.best_metric
                        )
                        if better:
                            self.best_metric = m
                            self.best_step = self.step
                            stale_evals = 0
                            if cfg.checkpoint_dir:
                                self.save()
                        else:
                            stale_evals += 1
                            if cfg.early_stopping_patience is not None and stale_evals >= cfg.early_stopping_patience:
                                break
                if cfg.checkpoint_dir and self.step % max(cfg.checkpoint_every, 1) == 0:
                    self.save()
        finally:
            if prefetch:
                batches.close()  # stops the feeder
        return {k: float(v) for k, v in last.items()}

    def best_or_latest_step(self) -> Optional[int]:
        """≡ ``best_or_latest_checkpoint`` (twml trainer.py:644-659)."""
        if self.best_step is not None:
            return self.best_step
        if self.config.checkpoint_dir:
            return self.latest_step()
        return self.step or None

    # -- checkpointing (tf.estimator checkpoints analog) --------------------

    def _ckpt_dir(self) -> str:
        if not self.config.checkpoint_dir:
            raise ValueError("no checkpoint_dir configured")
        return os.path.abspath(self.config.checkpoint_dir)

    def _state_file(self) -> str:
        """This rank's file in a step directory."""
        return "state.pt" if self.mesh is None else f"state.{self.mesh.position(JOINT_AXES)}.pt"

    def checkpoint_steps(self):
        """The steps saved under ``checkpoint_dir`` (on one device or on a
        mesh of any shape), ascending."""
        root = self._ckpt_dir()
        if not os.path.isdir(root):
            return []
        return sorted(int(d) for d in os.listdir(root)
                      if d.isdigit() and any(os.path.exists(os.path.join(root, d, f)) for f in _FIRST_FILES))

    def latest_step(self) -> Optional[int]:
        steps = self.checkpoint_steps()
        return steps[-1] if steps else None

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def save(self) -> None:
        """Checkpoint the model and the optimizer at this step (once a step:
        a best-eval save and the cadence may fall on the same one), then
        drop all but the newest ``keep_checkpoints``. On a mesh every rank
        calls it and writes its own blocks; the first rank makes the step's
        directory appear once all have written."""
        root = self._ckpt_dir()
        if self.latest_step() == self.step:
            return
        first = self.mesh is None or self.mesh.position(JOINT_AXES) == 0
        final = os.path.join(root, str(self.step))
        tmp = os.path.join(root, f".{self.step}.tmp")
        if first:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        self._barrier()
        state = {"step": self.step, "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}
        if self.mesh is not None:
            state["mesh"] = dict(self.mesh.shape)
            state["specs"] = {n: tuple(spec) for n, spec in self.specs.items()}
        torch.save(state, os.path.join(tmp, self._state_file()))
        self._barrier()
        if first:
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.checkpoint_steps()[: -max(self.config.keep_checkpoints, 1)]:
                shutil.rmtree(os.path.join(root, str(old)))
        self._barrier()

    def restore(self, step: Optional[int] = None) -> None:
        """Load the checkpoint of ``step`` (the latest when None), saved on
        one device or on a mesh of any shape, into this Trainer's layout:
        each rank (or the one device) gets the saved global arrays' values
        in its own blocks, params and optimizer state, and the step. A
        checkpoint of other parameter names or global shapes raises a
        ValueError naming both layouts."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._ckpt_dir()}")
        saved = _SavedCheckpoint(os.path.join(self._ckpt_dir(), str(step)), getattr(self, "specs", None))
        names = [n for n, _ in self.model.named_parameters()]
        shapes = {n: saved.global_shape(n) for n in saved.names}
        here = {n: self._global_shapes.get(n, tuple(t.shape)) for n, t in self.model.state_dict().items()}
        if shapes != here:
            apart = sorted(n for n in set(shapes) | set(here) if shapes.get(n) != here.get(n))
            raise ValueError(f"checkpoint of step {step} does not fit this Trainer: saved on {saved.layout()}, "
                             f"{ {n: shapes.get(n) for n in apart} }; here on {self._layout()}, "
                             f"{ {n: here.get(n) for n in apart} } (global shapes, None where absent)")
        if self.mesh is None:
            sizes, coords, specs = {}, {}, {}
        else:
            sizes = dict(self.mesh.shape)
            coords = {a: self.mesh.coord(a) for a in JOINT_AXES}
            specs = self.specs
        first = saved.file(0)
        model_state = dict(first["model"])
        opt_state = {}
        for i, n in enumerate(names):
            where = partition.block_slices(shapes[n], specs.get(n, partition.P()), sizes, coords)
            model_state[n] = saved.block(n, where, lambda f, n=n: f["model"][n])
            # the optimizer's tensors shaped like the param's block are sharded like it (moments); the rest
            # (Adam's count) is the same in every file
            state = first["optimizer"]["state"].get(i)
            if state is not None:
                opt_state[i] = {k: saved.block(n, where, lambda f, i=i, k=k: f["optimizer"]["state"][i][k])
                                if v.shape == first["model"][n].shape else v for k, v in state.items()}
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict({"state": opt_state, "param_groups": first["optimizer"]["param_groups"]})
        self.step = step

    def _layout(self) -> str:
        return "one device" if self.mesh is None else f"a {self.mesh.shape} mesh"

    # -- export (SavedModel-export analog: the train→serve artifact) ---------

    def _global_params(self) -> Dict[str, torch.Tensor]:
        """Each parameter's global array, by parameter name (collective on a
        mesh: every rank calls it and gets them all)."""
        if self.mesh is None:
            return {n: p.detach() for n, p in self.model.named_parameters()}
        return {n: partition.gather_block(p, self.mesh, self.specs[n]) for n, p in self.model.named_parameters()}

    def export(self, version_dir: str, extra: Optional[Dict[str, Any]] = None) -> Dict[str, np.ndarray]:
        """Write flat-dict params (+ host-side artifacts like calibration
        tables) as a registry-loadable version dir.

        ≡ twml's export_model/SavedModel hand-off (trainer.py:660) — the
        artifact ``serving.model_registry.ModelRegistry`` hot-swaps in. The
        names and layouts are the JAX package's
        (``core/partition.flax_layout``), the arrays the global ones. On a
        mesh every rank calls it and gets the dict; the first rank writes.
        """
        from the_algorithm_tpu_torch.serving import model_registry

        flat = partition.flax_flat(self.model, self._global_params())
        for k, v in (extra or {}).items():
            flat[k] = np.asarray(v)
        if self.mesh is None or self.mesh.position(JOINT_AXES) == 0:
            model_registry.save_params_npz(version_dir, flat)
        self._barrier()
        return flat


_FIRST_FILES = ("state.pt", "state.0.pt")  # the file a step directory saved on one device or on a mesh starts with


class _SavedCheckpoint:
    """One step directory's files, read lazily (memory-mapped on the CPU)
    and each at most once: the saved mesh shape and specs (a one-device
    file: one whole block; a mesh file without specs: ``specs``, the
    reader's own), and any region of a parameter's (or a tensor of its
    optimizer state's) global array from the saved blocks that cover it."""

    def __init__(self, root: str, specs: Optional[Dict[str, partition.PartitionSpec]]):
        self.root = root
        self.one_device = os.path.exists(os.path.join(root, "state.pt"))
        self._files: Dict[int, Any] = {}
        first = self.file(0)
        self.sizes = dict(first.get("mesh") or {a: 1 for a in JOINT_AXES})
        self.specs = first.get("specs", {} if self.one_device else specs)
        if self.specs is None and any(v > 1 for v in self.sizes.values()):
            raise ValueError(f"{root} was saved on a {self.sizes} mesh without its specs: restore it on a mesh "
                             "with the partition rules it was saved under")
        self.specs = self.specs or {}
        self.count = 1 if self.one_device else int(np.prod(list(self.sizes.values())))
        self.names = list(first["model"])  # params and buffers

    def file(self, j: int) -> Dict[str, Any]:
        if j not in self._files:
            name = "state.pt" if self.one_device else f"state.{j}.pt"
            self._files[j] = torch.load(os.path.join(self.root, name), map_location="cpu", mmap=True)
        return self._files[j]

    def coords(self, j: int) -> Dict[str, int]:
        """The mesh position of file ``j`` (its rank's joint position, the first axis major)."""
        out = {}
        for axis in reversed(JOINT_AXES):
            j, out[axis] = divmod(j, self.sizes[axis])
        return out

    def layout(self) -> str:
        return "one device" if self.one_device else f"a {self.sizes} mesh"

    def spec(self, name: str) -> partition.PartitionSpec:
        return partition.P(*self.specs.get(name, ()))

    def global_shape(self, name: str) -> Tuple[int, ...]:
        return partition.global_shape(self.file(0)["model"][name].shape, self.spec(name), self.sizes)

    def block(self, name: str, where: Tuple[slice, ...], tensor_of: Callable[[Dict[str, Any]], torch.Tensor]):
        """The region ``where`` of parameter ``name``'s global array (or of
        a tensor of the same layout: ``tensor_of`` picks it from a file),
        copied from each distinct saved block that meets it."""
        out = None
        seen = set()
        for j in range(self.count):
            src = partition.block_slices(self.global_shape(name), self.spec(name), self.sizes, self.coords(j))
            key = tuple((s.start, s.stop) for s in src)
            if key in seen:
                continue  # a replica of a block already copied
            seen.add(key)
            meet = [slice(max(a.start, b.start), min(a.stop, b.stop)) for a, b in zip(src, where)]
            if any(m.start >= m.stop for m in meet):
                continue
            t = tensor_of(self.file(j))
            if out is None:
                out = torch.empty(tuple(w.stop - w.start for w in where), dtype=t.dtype)
            out[tuple(slice(m.start - w.start, m.stop - w.start) for m, w in zip(meet, where))] = \
                t[tuple(slice(m.start - s.start, m.stop - s.start) for m, s in zip(meet, src))]
        return out


def make_auc_per_head_eval(
    predict_fn: Callable[[nn.Module, Any], Any],  # (model, batch) → [B, H] probs
    eval_batches,  # list of (batch, labels [B, H])
    head_names,
):
    """Per-engagement-head AUC eval loop ≡ the reference's per-class metric
    fns (``deepbird/.../earlybird/metrics.py``, push ``metric_fn_utils.py``).

    Returns an eval_fn(model) → {"auc/<head>": …, "auc_mean": …} usable as
    Trainer.fit's eval_fn (set config.eval_metric="auc_mean" for
    best-checkpoint selection). ``predict_fn`` runs under ``no_grad`` and
    returns a tensor or an array.
    """
    from the_algorithm_tpu_torch.training import metrics as M

    def host(x) -> np.ndarray:
        return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def eval_fn(model) -> Dict[str, float]:
        scores, labels = [], []
        with torch.no_grad():
            for batch, y in eval_batches:
                scores.append(host(predict_fn(model, batch)))
                labels.append(host(y))
        s = torch.from_numpy(np.concatenate(scores, axis=0))
        y = torch.from_numpy(np.concatenate(labels, axis=0))
        out: Dict[str, float] = {}
        aucs = []
        for h, name in enumerate(head_names):
            a = float(M.auc(s[:, h], y[:, h]))
            out[f"auc/{name}"] = a
            aucs.append(a)
        out["auc_mean"] = float(sum(aucs) / max(len(aucs), 1))
        return out

    return eval_fn
