"""frames_per_s: frames whose results the entry returned to the caller
(match records), over the whole window, from its start to the last
finalize."""


def read(run):
    return run["frames"] / run["window_s"]
