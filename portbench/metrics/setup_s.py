"""Process start to the first timed round, in s."""


def read(r):
    return float(r.setup_s)
