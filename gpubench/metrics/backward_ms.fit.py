"""backward_ms.fit: host milliseconds per step from the start of the loss's
backward to a ``torch.cuda.synchronize()`` at its end (traced runs only:
the synchronize is made only there)."""


def read(ctx):
    b = ctx.host.get("backward_s")
    if ctx.trace is None or ctx.unit != "step" or not b:
        return None
    return 1e3 * sum(b) / len(b)
