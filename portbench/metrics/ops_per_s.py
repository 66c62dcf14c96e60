"""Op rows applied per second of the window: every round's rows, the
drain included, over the whole window, batch opens included."""


def read(r):
    return float(r.rounds["rows"].sum() / r.window_s)
