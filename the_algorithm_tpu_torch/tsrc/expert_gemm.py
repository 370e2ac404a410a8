"""Triton source of :mod:`the_algorithm_tpu_torch.ops.expert_gemm`'s combine
kernel (the grouped GEMMs are CUDA C++: ``csrc/experts/expert_gemm.cu``).

This directory is no package: nothing imports it with the port, and the
machines without ``triton`` never read it. ``ops/expert_gemm.py`` loads this
file by path at its first launch on a card, as ``_build.py`` builds
``csrc/`` at first use.
"""

import triton
import triton.language as tl


@triton.jit
def moe_combine_kernel(y_ptr, w_ptr, shared_ptr, res_ptr, out_ptr, N, D,
                       K: tl.constexpr, BT: tl.constexpr, BD: tl.constexpr):
    """out[t] = res[t] + shared[t] + Σ_j w[t, j] · y[t · K + j], summed in f32
    (the routed terms in j order, then the shared expert, then the residual)
    and rounded once."""
    toks = tl.program_id(0) * BT + tl.arange(0, BT)
    dims = tl.program_id(1) * BD + tl.arange(0, BD)
    tmask = toks < N
    m2 = tmask[:, None] & (dims < D)[None, :]
    acc = tl.zeros((BT, BD), dtype=tl.float32)
    for j in tl.static_range(K):
        slot = toks.to(tl.int64) * K + j
        wj = tl.load(w_ptr + slot, mask=tmask, other=0.0)
        yj = tl.load(y_ptr + slot[:, None] * D + dims[None, :], mask=m2, other=0.0)
        acc += wj[:, None] * yj.to(tl.float32)
    off = toks[:, None].to(tl.int64) * D + dims[None, :]
    acc += tl.load(shared_ptr + off, mask=m2, other=0.0).to(tl.float32)
    acc += tl.load(res_ptr + off, mask=m2, other=0.0).to(tl.float32)
    tl.store(out_ptr + off, acc.to(out_ptr.dtype.element_ty), mask=m2)
