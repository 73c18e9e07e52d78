"""Set-up: process start to the first timed frame (host clock)."""


def read(run):
    return run.get("setup_s")
