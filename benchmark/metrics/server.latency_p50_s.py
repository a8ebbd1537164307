"""The median latency of every request sent in the window (MotionServer), seconds."""

from benchmark.core import readers


def read(obs):
    return readers.latency_p50(obs)
