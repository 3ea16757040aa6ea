"""Slots the engine served with after the offline profiler and the device
bill (``max_slots`` of the engine that ran)."""


def read(run):
    return run.slots
