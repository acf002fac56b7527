"""The device's idle share of the traced slice, in percent: 1 - (the
union of its device operations' intervals) / (the slice's length)."""


def read(r):
    return None if r.summary is None else r.summary.idle_percent()
