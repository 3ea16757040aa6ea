"""Committed tokens whose ids reached the host inside the window, over the
window's length (host clock, the stream callback's stamps): the positions
the stamped blocks show newly unmasked, not the program's count."""
from sbench import window


def read(run):
    return window.tok_s(run)
