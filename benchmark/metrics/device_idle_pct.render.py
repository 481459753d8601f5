"""The device's idle share, in %, over the device stretch of whole items
(images or steps): 1 - the union of the profiler's device operations'
intervals over the window from the first operation's start to the last
one's end."""


def read(rec):
    return rec.idle_pct()
