"""Where the port's entry points build their state.

The JAX package places arrays on its default backend; the port's builders
(model constructors, ``init_*`` and ``from_numpy`` of the index and graph
states) put theirs on the card unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device, what: str) -> torch.device:
    """The device ``what`` builds on: the card unless ``device`` names
    another. There is no fallback to the CPU: with no card, asking for it
    raises."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} builds on the GPU by default and none is available: pass device='cpu'")
    return device


def host_array(table) -> np.ndarray:
    """A host numpy copy of a table: a tensor on any device, or an array."""
    if isinstance(table, torch.Tensor):
        return table.detach().cpu().numpy()
    return np.asarray(table)
