"""forward_ms.shape: host milliseconds per step from the step's start to its
loss, which a ``torch.cuda.synchronize()`` ends (traced runs only: the
synchronize is made only there)."""


def read(ctx):
    f = ctx.host.get("forward_s")
    if ctx.trace is None or ctx.unit != "step" or not f:
        return None
    return 1e3 * sum(f) / len(f)
