"""The spread of chip_smoke.py's mo path posterior checks over draws: for
each seed, runs (f) (optimize_batch q = 4 on -Hartmann6, 4096 init points,
10 rounds) and (g) (Ehvi in f32 on mop2, d = 6, 4096 init points, 5
iterations) from a generator of that seed, then reads each final GP's
(each output's in (g)) f32 posterior at 64 points against the f64
posterior of its stored data, in units of its move under one f32
rounding of the inputs and distances (the variance's allowed move also
holding its own f32 cancellation, ``chip_smoke.posterior_move``), as
``check_posterior_exact`` does, beside the control (inputs moved by
``MO_CONTROL_REL``) in the same units, and each variance reading also in
the units of the rule before the cancellation term.  The
limit those checks hold is ``BO_SLACK`` (32) units.

    python3 scripts/torch_mo_spread.py [--seeds 0 1 2 ...]

Needs a card.  Prints one JSON line a seed, then the largest reading and
the smallest control of each over the seeds, and the card's name and
power limit."""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def readings(gp, Xq, control_rel: float = cs.MO_CONTROL_REL) -> dict:
    """check_posterior_exact's readings (chip_smoke.posterior_readings) in
    units of its allowed move (chip_smoke.posterior_move), the control's
    inputs moved by ``control_rel``; the variance's also in units of the
    inputs' f32 move alone (``*_before``, the rule before the cancellation
    term)."""
    r = cs.posterior_readings(gp, Xq, control_rel)
    move = cs.posterior_move(r)
    sm, mv, sv = move["mu"], move["var"], r["sens_var"]
    em = float((r["mu"].double() - r["mu64"]).abs().max())
    ev = float((r["var"].double() - r["var64"]).abs().max())
    return dict(mu=em / sm, var=ev / mv, control_mu=r["control_mu"] / sm,
                control_var=r["control_var"] / mv, var_before=ev / sv,
                control_var_before=r["control_var"] / sv,
                cancel_var=r["cancel_var"], sens_var=sv)


def summary(rows, runs) -> dict:
    """The largest reading and the smallest control of each run over the
    seeds, under the rule and under the rule before the cancellation
    term, beside the limit (BO_SLACK units)."""
    def over(k, keys, f):
        return f(f(r[k][x] for x in keys) for r in rows)

    return {
        "max_reading": {k: over(k, ("mu", "var"), max) for k in runs},
        "min_control": {k: over(k, ("control_mu", "control_var"), min)
                        for k in runs},
        "max_reading_before": {k: over(k, ("mu", "var_before"), max)
                               for k in runs},
        "min_control_before": {k: over(k, ("control_mu",
                                           "control_var_before"), min)
                               for k in runs},
        "limit": cs.BO_SLACK}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mo_spread.py: no CUDA device", file=sys.stderr)
        return 1
    import limbo_tpu_torch  # noqa: F401  (precision policy: TF32 off)
    from limbo_tpu_torch.acqui.qei import QEI
    from limbo_tpu_torch.bo import BOptimizer, MaxIterations, RandomSampling
    from limbo_tpu_torch.bo.multi import Ehvi
    from limbo_tpu_torch.kernels import SquaredExpARD

    dev = torch.device("cuda")
    rows = []
    for seed in args.seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        bo = BOptimizer(kernel=SquaredExpARD.create(dim=cs.BO_DIM,
                                                    device=dev),
                        init=RandomSampling(cs.MO_F_INIT),
                        stop=(MaxIterations(cs.MO_F_ROUNDS),), device=dev)
        state = bo.optimize_batch(cs.hartmann6, cs.BO_DIM, q=4,
                                  generator=gen, qei=QEI(n_samples=128),
                                  restarts=16, steps=30)
        row = dict(seed=seed, f=readings(state.gp, torch.rand(
            (cs.RESTARTS, cs.BO_DIM), generator=gen, device=dev)))
        del state, bo
        loop = Ehvi(ref=(-1.1, -1.1), init=RandomSampling(cs.MO_G_INIT),
                    stop=(MaxIterations(cs.MO_G_ITERS),),
                    dtype=torch.float32, device=dev)
        loop.optimize(cs.mop2, cs.MO_G_DIM, generator=gen)
        for j, g in enumerate(loop.model.gps):
            row[f"g{j}"] = readings(g, torch.rand(
                (cs.RESTARTS, cs.MO_G_DIM), generator=gen, device=dev))
        del loop
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rows.append(row)
    runs = [k for k in rows[0] if k != "seed"]
    print(json.dumps(summary(rows, runs) | {"seeds": args.seeds}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
