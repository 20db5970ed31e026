"""match_device_ms: device ms a batch of the match stage: the operations
launched under the harness's ``bench.match`` span around the match
program."""


def read(run):
    s = run["trace"]["spans"].get("bench.match")
    return None if s is None else s["device_ms"]
