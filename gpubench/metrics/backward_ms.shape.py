"""backward_ms.shape: host milliseconds per step from the end of the
forward's synchronize to a ``torch.cuda.synchronize()`` at the optimizer
step: the backward alone, with no forward kernel still queued (traced runs
only)."""


def read(ctx):
    b = ctx.host.get("backward_s")
    if ctx.trace is None or ctx.unit != "step" or not b:
        return None
    return 1e3 * sum(b) / len(b)
