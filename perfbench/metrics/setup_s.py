"""setup_s: process start to the window's start (loading, data from the
seed, fit, build, warm-up and capture; the first run in a checkout also
compiles the kernels), host clock."""


def read(ctx):
    return ctx.setup_s
