"""Mean requests per batch over max_batch, from MotionServer.batches, percent."""

from benchmark.core import readers


def read(obs):
    return readers.batch_fill(obs)
