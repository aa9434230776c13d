"""The mean time of the window's smooth optimizer steps (the smooth loss's
second query and double backward), CUDA events around
``Trainer.rays_step``, ms."""


def read(run):
    ms = run.window["step_ms"]["smooth"]
    return sum(ms) / len(ms) if ms else None
