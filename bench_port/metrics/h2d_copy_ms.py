"""h2d_copy_ms: device ms a batch of host-to-device copies (the frames'
upload and any small copies the program makes)."""


def read(run):
    return run["trace"]["h2d_ms"] or None
