"""setup_s: seconds from the first statement of `run.py` to the start of the
window (imports, CUDA context, kernel library, the input pool, warm-up)."""


def read(ctx):
    return ctx.setup_s
