"""device_idle_share: % of the profiled window of steady batches in which
no kernel, copy or memset runs on the card."""


def read(run):
    t = run["trace"]
    if not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
