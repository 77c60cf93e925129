"""K1-K4 launches a training step: the program's launch counters
(ops/counts.py; a CUDA-graph replay is credited with its captured
launches) over the window, per step the harness fed."""

ENTRIES = ("lstmp_train_fwd", "lstmp_train_bwd", "xent_affine_fwd",
           "xent_affine_bwd")


def read(ctx):
    steps = len(ctx.get("step_frames", ()))
    if ctx["kind"] != "train" or not steps:
        return None
    return sum(ctx["counts"].get(e, 0) for e in ENTRIES) / steps
