"""The same at the offline batch's shapes, percent."""

from benchmark.core import readers


def read(obs):
    return readers.roofline(obs, "attention")
