"""Median over the window's requests of their batch's time in MotionServer (the
span server.batch), seconds. It depends on the seed in mdm.serve_text, where
the median request rides a bucket-16 or a bucket-32 batch (see
benchmark/core/spans.py service_p50_s)."""

from benchmark.core import spans


def read(obs):
    return spans.service_p50_s(obs)
