"""Frames whose pose came out inside the window, over its seconds."""


def read(run):
    done = sum(1 for f in run.frames if f["ok"] and f["t_out"] is not None
               and f["t_out"] <= run.window_end)
    return done / run.seconds
