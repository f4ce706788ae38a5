"""launches_per_frame: the host's kernel-launch calls (cudaLaunchKernel*,
cuLaunchKernel*) in the traced slice over its frames."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("frames"):
        return None
    return tr["launches"] / tr["frames"]
