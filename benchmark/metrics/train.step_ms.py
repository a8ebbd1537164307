"""Device ms per replayed train step (CUDA events over back-to-back replays)."""

from benchmark.core import readers


def read(obs):
    return readers.step_ms(obs)
