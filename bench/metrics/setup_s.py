"""setup_s: from the process's start to the window's first batch:
imports, the kernels' load (and their build, in a checkout's first run),
the weights made on the device, the cache, one warm-up batch."""


def read(ctx):
    return ctx.setup_s
