"""Share of a traced slice of the offline window with no kernel on the device (torch.profiler), percent."""

from benchmark.core import readers


def read(obs):
    return readers.idle(obs)
