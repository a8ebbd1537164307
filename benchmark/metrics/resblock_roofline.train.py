"""The same over a train step's halves, forward and backward under autograd, percent."""

from benchmark.core import readers


def read(obs):
    return readers.roofline(obs, "resblock")
