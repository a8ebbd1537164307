"""p90 over the window's requests of their wait in MotionServer's queue (the span
server.queue), seconds; a request never taken into a batch counts as infinite."""

from benchmark.core import spans


def read(obs):
    return spans.queue_wait_p90_s(obs)
