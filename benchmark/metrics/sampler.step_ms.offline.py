"""Device ms per replayed sampler step at the offline batch (CUDA events over 100 replays)."""

from benchmark.core import readers


def read(obs):
    return readers.step_ms(obs)
