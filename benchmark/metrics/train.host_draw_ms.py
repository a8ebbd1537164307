"""Median host ms a train step spends drawing its keyframe masks (the span
train.host_draw), over the process's steps after the first, the set-up's
check steps included."""

from benchmark.core import spans


def read(obs):
    return spans.host_draw_ms(obs)
