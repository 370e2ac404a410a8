"""Partition rules: regex → PartitionSpec over a model's parameters.

Counterpart of ``the_algorithm_tpu/core/partition.py`` (the reference's
per-variable partitioners, ``tf.min_max_variable_partitioner`` in
``twml/twml/layers/full_sparse.py:124-135``, as declarative regex rules on
flattened parameter paths). The rules match the JAX package's flat names
(``params/user_table``, ``params/hidden/kernel``), the names
``Trainer.export`` writes, so the JAX package's rule lists apply verbatim.

A torch module's parameters reach those names through :func:`flax_layout`:
a module with a ``FLAX_COLLECTION`` (the flax variable collection,
``"params"``) names ``trunk.0.weight`` as ``params/trunk_0/kernel``; any
other keeps its parameter names, ``/``-joined. A flax ``Dense`` kernel is
[in, out] and a torch ``Linear.weight`` [out, in], so a kernel's spec
applies to the torch tensor with its entries swapped (:func:`torch_spec`):
``P(None, 'model')`` on a kernel splits the torch weight's dim 0.

Where the JAX package places global arrays on a mesh, a rank here keeps its
block (:func:`shard_tree`, :func:`shard_module`) and :func:`gather_block`
assembles the global array again. ``named_sharding``, ``tree_shardings``
and ``with_sharding_constraint`` have no counterpart: they hand XLA's
partitioner a placement, and a rank's program here states its blocks and
collectives itself (``core/mesh.py``).
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from the_algorithm_tpu_torch.core.mesh import DATA_AXIS, Mesh, shard_rows


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dim from the first, each
    an axis name, a tuple of axis names (split jointly, the first major) or
    None (not split); dims past the last entry are not split."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):  # unpickled as P(*entries), not P(entries)
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec
PartitionRules = Sequence[Tuple[str, PartitionSpec]]


def _items(tree):
    if isinstance(tree, PartitionSpec):  # a leaf of a spec tree
        return None
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple: its field names
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def _map(fn, tree, prefix=""):
    items = _items(tree)
    if items is None:
        return fn(prefix, tree)
    return _rebuild(tree, [_map(fn, v, f"{prefix}/{k}" if prefix else str(k)) for k, v in items])


def tree_path_names(tree: Any) -> Any:
    """The tree of '/'-joined key-path names with the same structure as
    ``tree`` (dict keys, sequence indices, NamedTuple fields)."""
    return _map(lambda name, _: name, tree)


def spec_for(rules: PartitionRules, name: str, shape) -> PartitionSpec:
    """The first rule whose regex is found in ``name``; a scalar or a
    size-1 leaf is never split. No match raises."""
    shape = tuple(shape)
    if len(shape) == 0 or int(np.prod(shape)) == 1:
        return P()
    for pattern, spec in rules:
        if re.search(pattern, name):
            return spec
    raise ValueError(f"no partition rule matched param '{name}'")


def match_partition_rules(rules: PartitionRules, tree: Any) -> Any:
    """The tree of PartitionSpecs ``rules`` give ``tree``'s leaves (arrays
    or tensors), by their path names."""
    return _map(lambda name, leaf: spec_for(rules, name, np.shape(leaf)), tree)


def spec_axes(spec: PartitionSpec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits over."""
    out = []
    for entry in spec:
        if entry is not None:
            out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


def local_block(x, mesh: Mesh, spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of the global array ``x`` (numpy or tensor) under
    ``spec``, on ``mesh.device``; a dim its axes do not divide raises."""
    t = torch.as_tensor(x)
    for dim, entry in enumerate(spec):
        if entry is not None:
            over = (entry,) if isinstance(entry, str) else tuple(entry)
            t = shard_rows(t, mesh, axis=dim, over=over, pad=False, what=f"dim {dim}")
    return t.contiguous().to(mesh.device)


def block_slices(shape, spec: PartitionSpec, sizes: Dict[str, int], coords: Dict[str, int]) -> Tuple[slice, ...]:
    """Where the block of the mesh position ``coords`` lies in a global
    array of ``shape`` under ``spec``, on a mesh of axis ``sizes`` (the
    block :func:`local_block` takes there): one slice a dim."""
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        pos, blocks = 0, 1
        for axis in () if entry is None else (entry,) if isinstance(entry, str) else entry:
            pos, blocks = pos * sizes[axis] + coords[axis], blocks * sizes[axis]
        per = n // blocks
        out.append(slice(pos * per, (pos + 1) * per))
    return tuple(out)


def global_shape(block_shape, spec: PartitionSpec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The global array's shape from one block's under ``spec`` on a mesh
    of axis ``sizes``."""
    out = list(block_shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            for axis in (entry,) if isinstance(entry, str) else entry:
                out[dim] *= sizes[axis]
    return tuple(out)


def gather_block(block: torch.Tensor, mesh: Mesh, spec: PartitionSpec) -> torch.Tensor:
    """The global array from every rank's ``block`` under ``spec``
    (collective: every rank of the mesh calls it)."""
    t = block.detach()
    for dim, entry in enumerate(spec):
        if entry is not None:
            for axis in reversed((entry,) if isinstance(entry, str) else tuple(entry)):
                t = mesh.all_gather(t.contiguous(), axis, dim=dim)
    return t


def shard_tree(tree: Any, mesh: Mesh, specs: Any) -> Any:
    """This rank's blocks of a tree of global arrays, each under its spec
    (``specs``: a tree of PartitionSpecs of the same structure)."""
    flat = {}
    _map(lambda name, spec: flat.__setitem__(name, spec), specs)
    return _map(lambda name, leaf: local_block(leaf, mesh, flat[name]), tree)


# -- torch modules under the JAX package's names ------------------------------


_NORMS = (nn.LayerNorm,)


def flax_layout(model: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """Each parameter's JAX flat name and whether the torch tensor is the
    transpose of the JAX array. With a ``FLAX_COLLECTION``: the collection
    first, ``name.<i>`` submodules as ``name_<i>``, a ``Linear``'s weight
    its transposed ``kernel`` and a norm's weight its ``scale`` (a module
    with ``FLAX_SCALE`` set counts as a norm); else the parameter names,
    '/'-joined."""
    collection = getattr(model, "FLAX_COLLECTION", None)
    if collection is None:
        return {n: (n.replace(".", "/"), False) for n, _ in model.named_parameters()}
    modules = dict(model.named_modules())
    out = {}
    for name, _ in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        mod = modules[owner]
        transposed = isinstance(mod, nn.Linear) and leaf == "weight"
        if transposed:
            leaf = "kernel"
        elif leaf == "weight" and (isinstance(mod, _NORMS) or getattr(mod, "FLAX_SCALE", False)):
            leaf = "scale"
        path = re.sub(r"\.(\d+)(?=\.|$)", r"_\1", owner).replace(".", "/")
        out[name] = ("/".join(p for p in (collection, path, leaf) if p), transposed)
    return out


def torch_spec(spec: PartitionSpec, transposed: bool, ndim: int) -> PartitionSpec:
    """A JAX array's spec as its torch tensor takes it: the entries padded
    to ``ndim`` with None, then reversed when the tensor is the array's
    transpose (a 2-D kernel)."""
    full = tuple(spec) + (None,) * (ndim - len(spec))
    return P(*reversed(full)) if transposed else P(*full)


def module_specs(model: nn.Module, rules: PartitionRules) -> Dict[str, PartitionSpec]:
    """Each parameter's spec in its torch layout: the rule its JAX name and
    JAX shape match, translated by :func:`torch_spec`."""
    layout = flax_layout(model)
    specs = {}
    for name, p in model.named_parameters():
        jax_name, transposed = layout[name]
        shape = tuple(reversed(p.shape)) if transposed else tuple(p.shape)
        specs[name] = torch_spec(spec_for(rules, jax_name, shape), transposed, p.dim())
    return specs


def shard_module(model: nn.Module, mesh: Mesh, rules: PartitionRules,
                 specs: Optional[Dict[str, PartitionSpec]] = None) -> Dict[str, PartitionSpec]:
    """Replace each parameter of ``model`` (holding the global array) by
    this rank's block under ``rules`` on ``mesh.device``; returns the specs."""
    specs = specs or module_specs(model, rules)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = local_block(p.data, mesh, specs[name])
    return specs


def flax_flat(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``tensors`` keyed by ``model``'s parameter names → numpy arrays under
    the JAX names and layouts (:func:`flax_layout`)."""
    layout = flax_layout(model)
    out = {}
    for name, t in tensors.items():
        jax_name, transposed = layout[name]
        t = t.detach().cpu()
        out[jax_name] = (t.T if transposed else t).contiguous().numpy()
    return out


# -- the batch a rank sees -----------------------------------------------------

_BATCH_SPLIT: ContextVar[Optional[Tuple[Mesh, Tuple[str, ...]]]] = ContextVar("batch_split", default=None)


@contextmanager
def batch_split(mesh: Mesh, axes=(DATA_AXIS,)):
    """Code run inside sees this rank's block of a batch split over
    ``axes`` of ``mesh`` (a sharded ``Trainer`` sets it around its loss).
    A loss over the whole batch (the in-batch softmax's negatives) gathers
    what it needs over ``axes`` (:func:`current_batch_split`)."""
    token = _BATCH_SPLIT.set((mesh, tuple(axes)))
    try:
        yield
    finally:
        _BATCH_SPLIT.reset(token)


def current_batch_split() -> Optional[Tuple[Mesh, Tuple[str, ...]]]:
    """(mesh, axes) of :func:`batch_split`, or None on one device."""
    return _BATCH_SPLIT.get()


def batch_axes_of(model) -> Tuple[str, ...]:
    """The mesh axes a model's batch is split over: ``model.batch_axes``
    where it says (an explicit row exchange reads the joint ('data',
    'model') batch), else ('data',): the 'model' ranks see the same rows."""
    return tuple(getattr(model, "batch_axes", (DATA_AXIS,)))

