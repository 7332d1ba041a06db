"""The fast-matmul mode: which f32 products may run in TF32 (port of the
precision policy of limbo_tpu/__init__.py:15-21).

``LIMBO_TPU_FAST_MATMUL`` is read once, when the package is imported, as
the reference reads it: any non-empty value turns the mode on.

* Unset (the default): every f32 product on the card runs in exact f32
  (cuBLAS with TF32 off), the counterpart of the reference's
  ``jax_default_matmul_precision = "highest"``.
* Set: cuBLAS's f32 GEMMs may run in TF32
  (``torch.backends.cuda.matmul.fp32_precision = "tf32"``), the products
  the reference leaves at its default precision.  Every product the
  reference pins at ``Precision.HIGHEST`` runs inside ``exact()`` (or a
  function wrapped by ``exact_products``) and stays exact f32.  TF32 keeps
  10 mantissa bits, more than the bf16 pass the reference's fast mode
  gives those products on a TPU, so the port stays inside the reference's
  own fast-mode contract.

Unchanged by the mode: the triangular solves, which the package runs
through ``solve_triangular`` below, inside ``exact()`` (cuBLAS's ``trsm``
does take the TF32 math mode: on an H100 a solve with 64 right-hand
sides gave other bits in fast mode); ``cholesky_ex`` (cuSOLVER; the same
bits in both modes on the card); f64 products; the CPU (it has no TF32:
a CPU run computes the same bits in both modes); and every hand-written
kernel (``csrc/*.cu``; none reads the switch).  cuBLAS
takes its math mode when a call is issued, so a CUDA graph captured in fast
mode replays fast-mode products (``bo/graph.py``).  Other backends (cuDNN,
oneDNN) are held at exact f32 in both modes; the port uses none of them for
a product.

Every f32 product of the package, by file and function, against the
reference's (``limbo_tpu/``) counterpart; ``exact`` runs exact f32 in both
modes, ``tf32`` may run TF32 in fast mode.  tests/test_torch_precision.py
records the precision in force at each product on the CPU and holds it to
this table (it parses the rows between the two ``--`` lines):

    file                          function                     mode   reference
    ----------------------------  ---------------------------  -----  ---------------------------
    utils/maths.py                sq_dist                      exact  utils/maths.py:29-34 HIGHEST
    utils/maths.py                _ExactCross.forward          exact  sq_dist's product in fast mode
    utils/maths.py                _ExactCross.backward         exact  its backward (the VJP of a HIGHEST dot)
    ops/gram_pallas.py            gram_plain                   exact  kernels 1-2's plain version (the distance product)
    ops/chol.py                   cholesky_blocked             exact  ops/chol.py:36,70,319-332 HIGHEST
    ops/chol.py                   tri_inv_blocked              exact  ops/chol.py:338-366 HIGHEST
    ops/chol.py                   tri_inv_panel_plain          exact  kernel 5's plain version, chol.py:233-256 HIGHEST
    ops/chol.py                   _Cholesky.backward           exact  ops/chol.py:430-435 HIGHEST
    ops/trimv.py                  trimv                        exact  ops/trimv.py:76,82 HIGHEST (the library route)
    ops/trimv.py                  trimv_plain                  exact  kernel 3's plain version, trimv.py:76,82 HIGHEST
    ops/mirror.py                 mirror_mm_plain              exact  the exact-sum mirror kernel's plain version
    models/gp.py                  _mirror_from_linv            exact  models/gp.py:328-329 HIGHEST
    models/gp.py                  _kinv_from_linv              exact  models/gp.py:462-463 HIGHEST (blocked route)
    parallel/sharded_chol.py      _factor_loop                 exact  parallel/sharded_chol.py:153,159 HIGHEST
    models/gp.py                  QueryCache.build             tf32   models/gp.py:432,479
    models/gp.py                  add_sample_ok                tf32   models/gp.py:228
    models/gp.py                  query                        tf32   models/gp.py:299
    models/gp.py                  _mirror_mm                   tf32   models/gp.py:496,502,534 (an f32 mirror)
    models/gp.py                  _linv_solve                  tf32   models/gp.py:456-457,862-863
    models/gp.py                  _corr_t                      tf32   models/gp.py:536
    models/gp.py                  query_cached                 tf32   models/gp.py:572
    models/gp.py                  add_sample_cached            tf32   models/gp.py:707,714,727,734,769
    models/gp.py                  _pivot                       tf32   models/gp.py:711-715,726,730
    models/gp.py                  _add_sample_deferred         tf32   models/gp.py:813,825-826
    models/gp.py                  _flush_local                 tf32   models/gp.py:839,867
    models/iterative.py           blocked_kernel_matvec        tf32   models/iterative.py:55
    models/iterative.py           query                        tf32   models/iterative.py:225
    models/spgp.py                _fitc_terms                  tf32   models/spgp.py:81,84
    models/spgp.py                query                        tf32   models/spgp.py:167
    kernels/kernels.py            SquaredExpARD.gram_core      tf32   kernels/kernels.py:122
    kernels/kernels.py            SquaredExpARD._fused_train_args  tf32  kernels/kernels.py:137
    means/means.py                FunctionARD.forward          tf32   means/means.py:153
    acqui/qei.py                  joint_posterior              tf32   acqui/qei.py:32,36
    acqui/qei.py                  QEI.__call__                 tf32   acqui/qei.py:71
    ops/ehvi.py                   _g_max_interval              tf32   ops/ehvi.py:278,280
    opt/cmaes.py                  Cmaes.generation             tf32   opt/cmaes.py:96,111,120
    parallel/sharded_chol.py      _forward_solve               tf32   parallel/sharded_chol.py:165,169
    parallel/sharded_chol.py      _backward_solve              tf32   parallel/sharded_chol.py:180-182
    parallel/sharded_chol.py      sharded_query                tf32   parallel/sharded_chol.py:295
    parallel/sharded_acq.py       sharded_query_cached         tf32   parallel/sharded_acq.py:162
    parallel/sharded_acq.py       _pending_correction          tf32   parallel/sharded_acq.py:170
    parallel/sharded_acq.py       _flush_panel                 tf32   parallel/sharded_acq.py:244,251
    parallel/sharded_big.py       big_query                    tf32   parallel/sharded_big.py:233
    parallel/sharded_big.py       _big_add                     tf32   parallel/sharded_big.py:300,337-338
    parallel/sharded.py           row_sharded_posterior_mean   tf32   parallel/sharded.py:112
    parallel/distributed_gp.py    sharded_kernel_matvec        tf32   parallel/distributed_gp.py:42
    parallel/dryrun.py            run_dryrun_2d                tf32   parallel/dryrun.py:174
    benchmarks/oracle.py          _nll_and_grad                tf32   benchmarks/oracle.py:64 (f64: no effect)
    benchmarks/oracle.py          query                        tf32   benchmarks/oracle.py:121 (f64: no effect)
    ----------------------------  ---------------------------  -----  ---------------------------

A ``tf32`` product that cuBLAS runs as a matrix-vector product or a dot
(``gemv``, ``dot``) has no TF32 path and stays exact, which the mode
allows.  Autograd's backward products follow their forward's row: the
backward of ``sq_dist`` and of the Cholesky pullback run exact, the rest at
the mode.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

_fast = False


def _set_fast(on: bool) -> bool:
    """Set the mode for the process and return the previous one (the import
    sets it from the environment; checks that flip it restore it)."""
    global _fast
    prev, _fast = _fast, bool(on)
    torch.backends.cuda.matmul.fp32_precision = "tf32" if _fast else "ieee"
    return prev


def fast_mode() -> bool:
    """True when the process runs in fast-matmul mode."""
    return _fast


def in_force() -> str:
    """The cuBLAS f32 product precision in force: "ieee" or "tf32"."""
    return torch.backends.cuda.matmul.fp32_precision


@contextlib.contextmanager
def exact():
    """Run the products inside in exact f32, whatever the mode (a no-op
    when the mode is off)."""
    if not _fast:
        yield
        return
    prev = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.fp32_precision = prev


def solve_triangular(A: torch.Tensor, B: torch.Tensor, *,
                     upper: bool) -> torch.Tensor:
    """``torch.linalg.solve_triangular`` with its forward in exact f32 in
    both modes (its backward follows the mode, as autograd's products
    do)."""
    with exact():
        return torch.linalg.solve_triangular(A, B, upper=upper)


def exact_products(fn):
    """Decorator: every product of ``fn`` runs in exact f32."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with exact():
            return fn(*args, **kwargs)
    return wrapper


# one API for every backend (recent torch refuses a mix of the legacy
# allow_tf32 flags and fp32_precision): exact f32 everywhere, then cuBLAS's
# GEMMs by the mode
torch.backends.fp32_precision = "ieee"
_set_fast(bool(os.environ.get("LIMBO_TPU_FAST_MATMUL")))
