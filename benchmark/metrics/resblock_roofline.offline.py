"""Sum of bounds over sum of times of one offline forward's resblock halves, each timed alone, percent."""

from benchmark.core import readers


def read(obs):
    return readers.roofline(obs, "resblock")
