"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Importing this module pins PyTorch to one CPU thread: the suite runs under
several xdist workers, and each worker's intra-op pool would otherwise
claim every core.
"""

import numpy as np
import pytest
import torch

from the_algorithm_tpu_torch.ops.sparse import PAD_ID

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def collapse_to_dict(rep, *sums):
    """One collapsed row → {id: (sum_1, ..., sum_k)}; PAD slots dropped."""
    rep = np.asarray(rep)
    out = {}
    for i in range(rep.shape[0]):
        if rep[i] != PAD_ID:
            assert int(rep[i]) not in out, "duplicate representative"
            out[int(rep[i])] = tuple(float(np.asarray(s)[i]) for s in sums)
    return out


def assert_same_collapse(got: dict, want: dict, rtol=1e-5, atol=1e-6):
    assert set(got) == set(want)
    for t in got:
        np.testing.assert_allclose(got[t], want[t], rtol=rtol, atol=atol)


def assert_same_topk(ids_a, scores_a, ids_b, scores_b, rtol=1e-5):
    """Two [Q, X] top-K lists agree as score-aligned sets.

    The score columns agree within ``rtol``; an id may sit in one list and
    not the other only where its score ties the list's last kept score
    (``torch.topk`` does not keep ``lax.top_k``'s order among ties); every
    id in both lists has the same score in both.
    """
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    scores_a, scores_b = np.asarray(scores_a), np.asarray(scores_b)
    assert ids_a.shape == ids_b.shape
    np.testing.assert_allclose(scores_a, scores_b, rtol=rtol)
    for q in range(ids_a.shape[0]):
        a = {int(i): float(s) for i, s in zip(ids_a[q], scores_a[q]) if i != PAD_ID}
        b = {int(i): float(s) for i, s in zip(ids_b[q], scores_b[q]) if i != PAD_ID}
        assert len(a) == len(b)
        for t in a.keys() & b.keys():
            np.testing.assert_allclose(a[t], b[t], rtol=rtol)
        if a:
            cut = min(a.values())
            for t in a.keys() ^ b.keys():
                s = a.get(t, b.get(t))
                np.testing.assert_allclose(s, cut, rtol=rtol)
