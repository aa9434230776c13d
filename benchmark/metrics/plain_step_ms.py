"""The mean time of the window's plain optimizer steps, CUDA events
around ``Trainer.rays_step``, ms."""


def read(run):
    ms = run.window["step_ms"]["plain"]
    return sum(ms) / len(ms) if ms else None
