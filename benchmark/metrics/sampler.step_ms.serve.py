"""Device ms per replayed sampler step at the served cell's full bucket (CUDA events over 100 replays)."""

from benchmark.core import readers


def read(obs):
    return readers.step_ms(obs)
