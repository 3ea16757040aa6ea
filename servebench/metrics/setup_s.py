"""Seconds from the harness's start to the window's opening: imports,
weights drawn, engine built, every stage captured and billed, requests
submitted (host clock)."""


def read(run):
    return run.setup_s
