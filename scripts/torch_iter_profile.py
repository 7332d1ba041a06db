#!/usr/bin/env python3
"""Where the time of one cached BO iteration of the PyTorch port goes, on
the card.

Builds chip_smoke.py's main path (its ``MainPath``: n = 10,000, d = 8,
capacity 10240, SquaredExpARD + DataMean, bf16 mirror, defer_m = 32,
RandomRestarts of Rprop(20) x 64 restarts + a 1024-point sweep maximizing
UCB, deferred appends), runs one warm-up iteration, then:

* times the acquisition and the append of each of ``--iters`` iterations
  with the host clock around work that ends in a synchronize;
* traces ``--trace-iters`` more iterations with torch.profiler and prints
  the device time by kernel, the device-busy total and the idle share of
  the traced wall time, and writes the Chrome trace to ``--trace`` if given.

With ``--graph`` it profiles the same iteration captured as CUDA graphs
(``bo/graph.BOStep``, the path of ``bench_torch.py``): after the warm-up
iteration and the capture, it times ``--iters`` replays (the host's time to
issue one, and the time to its synchronize), then traces ``--trace-iters``
replays as above.

With ``--hp`` it profiles, instead, ``--trace-iters`` f32 LML + gradient
evaluations of chip_smoke.py's hp path (n = 16,384, capacity 16896, after
the blocked-Cholesky fit), the unit of work of its hyperparameter learning.

With ``--lite`` the iteration is chip_smoke.py's lite path's instead
(scripts/large_n_bench.py --lite 32768: n = 32,768, capacity 33,280, the
hp path's kernel, the lite cache: Linv and a bf16 mirror, defer_m = 256),
eager or, with ``--graph``, captured.

With ``--mo RUN`` it profiles one iteration of chip_smoke.py's mo path
run RUN instead: ``a`` (Ehvi on mop2, f64), ``d`` (Ehvi q = 2, f64),
``e`` (Ehvi on DTLZ2 with 3 objectives, f64) or ``g`` (Ehvi in f32 at
4096 points, d = 6) after its init design and 2 warm-up iterations, each
traced iteration followed by the loop's closing refit; ``f`` traces one
``propose_batch`` (q = 4, 16 restarts, Rprop(30), QEI(128)) on the
optimize_batch state after 4096 init points and one round.

With ``--cbo`` it profiles one iteration of chip_smoke.py's cbo path (a)
instead (CBOptimizer in f32 on -Hartmann6 with its constraint, 4096 init
points, capacity 4160: both GPs refitted, then ECI maximized by 64 x
Rprop(20) from a 1024-point sweep), after the init design and one warm-up
iteration.

With ``--suite VARIANT`` it profiles one captured iteration of that BO
suite variant (``benchmarks/bo_suite.default_variants()``, e.g.
``opt_cmaes``) on Hartmann6 (d = 6) at the suite's protocol (f32, 10 init
points, the step of ``optimize_jit``): replay times as with ``--graph``,
then a trace with the eigensolver's (``sym_eig_kernel``) share of the
device time, then one whole run of the variant (``bo_suite.run_one``, 190
iterations) and its time.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/torch_iter_profile.py [--iters 10] [--trace-iters 3]
        [--trace out/trace.json]
        [--graph | --hp | --mo RUN | --cbo | --suite VARIANT] [--lite]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def lml_step(gp):
    """One f32 LML + gradient in the kernel's log-parameters, as each
    hp-opt step evaluates it."""
    from limbo_tpu_torch.models import gp as gp_mod

    def step():
        p = gp.kernel.params.clone().requires_grad_(True)
        v = gp_mod.log_marginal_likelihood(gp.kernel.with_params(p), gp.mean,
                                           gp.x, gp.y, gp.n)
        torch.autograd.grad(v, p)
    return step


def mo_step(which: str, dev, gen):
    """One iteration of chip_smoke.py's mo path run `which`, warmed up;
    returns (step, what a step is)."""
    import chip_smoke as cs
    from limbo_tpu_torch.acqui.qei import QEI, propose_batch
    from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling
    from limbo_tpu_torch.bo.multi import Ehvi
    from limbo_tpu_torch.kernels import SquaredExpARD

    if which == "f":
        bo = BOptimizer(kernel=SquaredExpARD.create(dim=cs.BO_DIM,
                                                    device=dev),
                        init=RandomSampling(cs.MO_F_INIT),
                        stop=(MaxIterations(1),), device=dev)
        state = bo.optimize_batch(cs.hartmann6, cs.BO_DIM, q=4,
                                  generator=gen, qei=QEI(n_samples=128))

        def step():
            propose_batch(state.gp, 4, gen, qei=QEI(n_samples=128),
                          restarts=16, steps=30)
        return step, "q = 4 proposals at n = 4100"
    f64 = dict(device=dev, dtype=torch.float64)
    runs = {"a": (dict(ref=(-1.1, -1.1), **f64), cs.mop2, 2),
            "d": (dict(ref=(-1.1, -1.1), q=2, gh_nodes=12, **f64), cs.mop2,
                  2),
            "e": (dict(ref=(-1.2,) * 3, **f64), cs.dtlz2_3, 3),
            "g": (dict(ref=(-1.1, -1.1), init=RandomSampling(cs.MO_G_INIT),
                       dtype=torch.float32, device=dev), cs.mop2,
                  cs.MO_G_DIM)}
    kw, f, dim = runs[which]
    loop = Ehvi(stop=(MaxIterations(2),), **kw)
    loop.optimize(f, dim, generator=gen)

    def step():
        loop.stop = (MaxIterations(loop.iteration + 1),)
        loop.optimize(f, dim, generator=gen, reset=False)
    return step, f"Ehvi iterations of mo path ({which})"


def cbo_step(dev, gen):
    """One iteration of chip_smoke.py's cbo path (a), warmed up."""
    import chip_smoke as cs
    from limbo_tpu_torch.bo import MaxIterations, RandomSampling
    from limbo_tpu_torch.bo.cbo import CBOptimizer

    bo = CBOptimizer(nb_constraints=1, init=RandomSampling(cs.CBO_INIT),
                     stop=(MaxIterations(1),), dtype=torch.float32,
                     device=dev)
    bo.optimize(cs.cbo_objective, cs.BO_DIM, generator=gen)

    def step():
        bo.stop = (MaxIterations(bo.iteration + 1),)
        bo.optimize(cs.cbo_objective, cs.BO_DIM, generator=gen, reset=False)
    return step, f"CBOptimizer iterations of cbo path (a) at n = {len(bo.X)}"


def suite_step(name: str, dev, gen):
    """The captured step of BO suite variant `name` on Hartmann6 as
    ``optimize_jit`` builds it (the init design appended eagerly, no
    history rows); returns (step, the variant)."""
    from limbo_tpu_torch.benchmarks import bo_suite
    from limbo_tpu_torch.benchmarks.functions import HARTMANN6
    from limbo_tpu_torch.bo.graph import BOStep
    from limbo_tpu_torch.models.dispatch import add_sample_any

    variant = {v.name: v for v in bo_suite.default_variants()}[name]
    bo = bo_suite.make_optimizer(variant, HARTMANN6, device=dev)
    f = HARTMANN6.as_max_objective(dev, torch.float32)
    d = HARTMANN6.dim_in
    gp = bo._make_gp(d, 1, bo._capacity())
    for x in bo.init(gen, d, dtype=bo.dtype):
        gp = add_sample_any(gp, x, f(x).to(bo.dtype).reshape(1))
    step = BOStep(gp, None, lambda model, it: bo._maximize(model, it, gen).x,
                  f, gen, fast_update=bo.cache_fast_update)
    return step, variant


def trace(step, reps: int, what: str, out):
    """Run `step` `reps` times under torch.profiler; print the wall time,
    the device-busy total, the idle share and the device time by kernel;
    returns (wall ms, busy ms, [(kernel, device us, launches)]), a step's
    each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (the kernels and copies themselves): an
    # operator's row would count its kernels' time a second time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    print(f"traced {reps} {what}: wall {1e3 * wall:.3f} ms, device busy "
          f"{1e3 * busy:.3f} ms, idle share {1.0 - busy / wall:.3f}")
    print(f"device time by kernel (ms and launches per one of the {what}):")
    # the 20 largest, and every kernel of the port's own csrc/ beside them
    own = ("gram_kernel", "gram_train_kernel", "lower_mv_kernel",
           "lower_tmv_kernel", "tri_inv_panel_kernel",
           "panel_factor", "mirror_mm", "round_a_kernel", "chunk_sum",
           "sym_eig_kernel")
    for i, (key, us, count) in enumerate(rows):
        if i < 20 or any(k in key for k in own):
            print(f"  {us / 1e3 / reps:9.4f}  {count / reps:7.1f}  "
                  f"{key[:90]}")
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
    return (1e3 * wall / reps, 1e3 * busy / reps,
            [(k, us / reps, c / reps) for k, us, c in rows])


def profile_suite(name: str, dev, gen, args, card) -> int:
    """One captured iteration of suite variant `name`: replay times, a
    trace with the eigensolver's share, then one whole run."""
    from limbo_tpu_torch.benchmarks import bo_suite
    from limbo_tpu_torch.benchmarks.functions import HARTMANN6

    step, variant = suite_step(name, dev, gen)
    replay_times(step, args.iters)
    wall, busy, rows = trace(step.step, args.trace_iters,
                             f"captured {name} iterations", args.trace)
    eig_us = sum(us for k, us, _ in rows if "sym_eig_kernel" in k)
    eig_n = sum(n for k, _, n in rows if "sym_eig_kernel" in k)
    print(f"{name} iteration (traced): wall {wall:.3f} ms, busy "
          f"{busy:.3f} ms, idle share {1.0 - busy / wall:.3f}; the "
          f"eigensolver {eig_us / 1e3:.4f} ms in {eig_n:.0f} launches, "
          f"{eig_us / 1e3 / busy:.3f} of busy", flush=True)
    iters = 190                                  # the suite's protocol
    acc, ms, capture = bo_suite.run_one(variant, HARTMANN6, n_iters=iters,
                                        device=dev)
    print(f"one {name} run on Hartmann6 ({iters} iterations): {ms:.1f} ms, "
          f"of it warm-up and capture {capture:.1f} ms; accuracy "
          f"{acc:.6f}", flush=True)
    print(f"card: {card}")
    return 0


def profile_graph(path, gp, cache, args, card) -> int:
    """The path's iteration captured: replay times, then a trace."""
    from limbo_tpu_torch.bo.graph import BOStep

    step = BOStep(gp, cache, lambda model, it: path.propose(model, path.gen),
                  path.objective, path.gen, fast_update="deferred")
    replay_times(step, args.iters)
    trace(step.step, args.trace_iters, "captured iterations", args.trace)
    print(f"card: {card}")
    return 0


def replay_times(step, iters: int) -> None:
    """The warm-up iteration and capture of `step`, then `iters` replays:
    the host's time to issue one and the time to its synchronize."""
    t0 = time.perf_counter()
    step.step()                                   # warm-up and capture
    torch.cuda.synchronize()
    print(f"warm-up iteration and capture: "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms", flush=True)
    t_issue, t_all = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        step.step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t_issue.append(t1 - t0)
        t_all.append(time.perf_counter() - t0)
    print(f"per replay over {iters}: issued in "
          f"{1e3 * sum(t_issue) / len(t_issue):.3f} ms (min "
          f"{1e3 * min(t_issue):.3f}), to its synchronize "
          f"{1e3 * sum(t_all) / len(t_all):.3f} ms (min "
          f"{1e3 * min(t_all):.3f}), host clock; launches per replay "
          f"{step.launches()}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace-iters", type=int, default=3)
    ap.add_argument("--trace", type=Path, default=None,
                    help="write the Chrome trace of the traced iterations")
    ap.add_argument("--hp", action="store_true",
                    help="profile LML + gradient evaluations of the hp path")
    ap.add_argument("--graph", action="store_true",
                    help="profile the captured iteration (bo/graph.BOStep)")
    ap.add_argument("--lite", action="store_true",
                    help="the lite path's iteration at n = 32,768")
    ap.add_argument("--mo", choices=("a", "d", "e", "f", "g"),
                    help="one iteration of a run of chip_smoke's mo path")
    ap.add_argument("--cbo", action="store_true",
                    help="one iteration of chip_smoke's cbo path (a)")
    ap.add_argument("--suite", metavar="VARIANT",
                    help="one captured iteration of a BO suite variant on "
                    "Hartmann6, and one whole run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_iter_profile: CUDA is not available", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    import chip_smoke as cs
    from limbo_tpu_torch.ops import _cuda

    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    _cuda.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.suite:
        return profile_suite(args.suite, dev, gen, args, card)
    if args.mo or args.cbo:
        step, what = (mo_step(args.mo, dev, gen) if args.mo
                      else cbo_step(dev, gen))
        step()                                                # warm-up
        torch.cuda.synchronize()
        trace(step, args.trace_iters, what, args.trace)
        print(f"card: {card}")
        return 0
    if args.hp:
        path = cs.MainPath(dev, gen, n=cs.HP_N, capacity=cs.HP_CAPACITY,
                           ell=cs.HP_ELL, noise=cs.HP_NOISE,
                           y_noise=cs.HP_Y_NOISE)
        gp = path.fit()
        step = lml_step(gp)
        step()                                                # warm-up
        torch.cuda.synchronize()
        trace(step, args.trace_iters, "LML + gradient evaluations",
              args.trace)
        print(f"card: {card}")
        return 0
    if args.lite:
        from limbo_tpu_torch.models import gp as gp_mod

        path = cs.MainPath(dev, gen, n=cs.LITE_N, capacity=cs.LITE_CAPACITY,
                           ell=cs.HP_ELL, noise=cs.HP_NOISE,
                           y_noise=cs.HP_Y_NOISE)
        gp = path.fit()
        cache = gp_mod.QueryCache.build(gp, with_Linv=True,
                                        qdtype=torch.bfloat16,
                                        defer_m=cs.LITE_DEFER_M, lite=True)
    else:
        path = cs.MainPath(dev, gen)
        gp = path.fit()
        cache = path.build(gp)
    if args.graph:
        return profile_graph(path, gp, cache, args, card)
    gp, cache = path.iterate(gp, cache)                       # warm-up
    torch.cuda.synchronize()
    t_acq, t_app = [], []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        x = path.acquire(gp, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gp, cache = path.append(gp, cache, x)
        torch.cuda.synchronize()
        t_acq.append(t1 - t0)
        t_app.append(time.perf_counter() - t1)
    print(f"per iteration over {args.iters}: acquisition "
          f"{1e3 * sum(t_acq) / len(t_acq):.3f} ms (min "
          f"{1e3 * min(t_acq):.3f}), append "
          f"{1e3 * sum(t_app) / len(t_app):.3f} ms (min "
          f"{1e3 * min(t_app):.3f}), host clock around synchronize",
          flush=True)

    state = [gp, cache]

    def step():
        state[:] = path.iterate(*state)

    trace(step, args.trace_iters, "iterations", args.trace)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
