"""Median time from a batch's last result to the next batch's sampler run
(server.gather + server.load), over the batches that found a request waiting, ms."""

from benchmark.core import spans


def read(obs):
    return spans.batch_gap_ms(obs)
