"""The served step's model FLOPs (counts/) over its device time, share of the stated type's peak, percent."""

from benchmark.core import readers


def read(obs):
    return readers.mfu(obs)
