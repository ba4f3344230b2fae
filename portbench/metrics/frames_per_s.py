"""frames_per_s (frames/s): frames whose answers arrived inside the
measured window, over the window's length, on the host clock."""


def read(run):
    return run.frames_per_s()
