"""scene_build_s: host seconds of the program's ``SceneBuilder.build`` on the
card, ending in ``torch.cuda.synchronize()`` (in the fit, the first build)."""


def read(ctx):
    return ctx.host.get("scene_build_s")
