"""setup_s: seconds from the process's start to the window's start: imports,
CUDA start-up, kernel libraries (built on a checkout's first run), the
benchmark's inputs, the program's scene build and its warm frames or steps."""


def read(ctx):
    return ctx.setup_s
