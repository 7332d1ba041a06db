"""mirror_roofline.bo: the mirror product's share of its roofline over the
traced slice, in %: the sum of each launch's bound over the sum of the
time of its kernels (the rounding of ks, the product, the chunks' sum).

The product's kernel is compiled per row tile: 64 rows for the ascent's
``restarts`` points, 128 for the sweep's ``sweep`` points, which tells the
launches apart.  Each reads the (capacity, capacity) bf16 mirror; its bound
is the larger of its bytes over HBM bandwidth and its operations at the
dense bf16 rate (counts/flops.py)."""

from perfbench.counts import flops

_PARTS = ("mirror_mm_kernel", "round_a_kernel", "chunk_sum_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    acq = ctx.cfg["acquisition"]
    N = ctx.cfg["capacity"]
    q_of = {"mirror_mm_kernel<64": acq["restarts"],
            "mirror_mm_kernel<128": acq["sweep"]}
    bound = spent = 0.0
    for name, s, e in ctx.trace.device_ops:
        if not any(p in name for p in _PARTS):
            continue
        spent += (e - s) / 1e9
        for tag, q in q_of.items():
            if tag in name:
                bound += flops.bound_s(flops.mirror_mm_bytes(q, N, N),
                                       flops.mirror_mm_ops(q, N, N),
                                       flops.PEAK_BF16)
    if bound == 0.0 or spent == 0.0:
        return None
    return 100.0 * bound / spent
