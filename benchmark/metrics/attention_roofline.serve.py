"""Sum of bounds over sum of times of one served forward's self-attention calls, each timed alone, percent."""

from benchmark.core import readers


def read(obs):
    return readers.roofline(obs, "attention")
