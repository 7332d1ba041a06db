"""The spread of chip_smoke.py's SPGP checks over data sets: for each seed,
the models path's SPGP (c) on its own draw of the lite path's data
(n = 32,768, d = 8, SquaredExpARD l = 0.3, noise 0.09, y = sin(3 sum x) +
0.3 e, m = ceil(0.1 n) pseudo-inputs from the same generator), its f32
NLML, gradient and query against f64, each in units of chip_smoke.py's
limit, and the controls (inputs moved by 2^-9) in the same units.

    python3 scripts/torch_spgp_spread.py [--seeds 0 1 2 ...] [--n 32768]

Needs a card.  Prints one JSON line a seed, then one line with the
largest reading and the smallest control of each check over the seeds,
and the card's name and power limit."""

import argparse
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--n", type=int, default=cs.LITE_N)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_spgp_spread.py: no CUDA device", file=sys.stderr)
        return 1
    from limbo_tpu_torch.models import spgp

    dev = torch.device("cuda")
    rows = []
    for seed in args.seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        path = cs.MainPath(dev, gen, n=args.n, capacity=args.n,
                           ell=cs.HP_ELL, noise=cs.HP_NOISE,
                           y_noise=cs.HP_Y_NOISE)
        sp = spgp.fit(path.kernel, path.mean, path.X, path.Y, generator=gen,
                      device=dev)
        Xq = torch.rand((cs.RESTARTS, path.X.shape[1]), generator=gen,
                        device=dev)
        v, g = cs.spgp_value_grad(sp, spgp, sp.xb, sp.kernel.params, sp.x,
                                  sp.y)
        r = cs.spgp_readings(sp, spgp, Xq, v, g)
        r = dict(seed=seed, **r, **{
            f"{k}_in_limit": r[f"{k}_err"] / r[f"{k}_tol"]
            for k in ("nlml", "grad", "query")}, **{
            f"{k}_control_in_limit": r[f"{k}_control"] / r[f"{k}_tol"]
            for k in ("grad", "query")})
        print(json.dumps(r), flush=True)
        rows.append(r)
        del sp, path, v, g
        torch.cuda.empty_cache()
    summary = {f"max_{k}_in_limit": max(r[f"{k}_in_limit"] for r in rows)
               for k in ("nlml", "grad", "query")}
    summary.update({f"min_{k}_control_in_limit": min(
        r[f"{k}_control_in_limit"] for r in rows) for k in ("grad",
                                                             "query")})
    summary["seeds"] = args.seeds
    print(json.dumps(dict(summary, card=cs.card_line())))
    ok = all(math.isfinite(v) for v in summary.values()
             if isinstance(v, float))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
