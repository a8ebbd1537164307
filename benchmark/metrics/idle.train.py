"""Share of a traced slice of the training window with no kernel on the device (torch.profiler), percent."""

from benchmark.core import readers


def read(obs):
    return readers.idle(obs)
