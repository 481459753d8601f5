"""Rank 0's device idle share, in %, over the device stretch of whole
images: 1 - the union of the profiler's device operations' intervals
(kernel 2, the fold, NCCL's all-reduce, to_u8 and the copies) over the
window from the first operation's start to the last one's end."""


def read(rec):
    return rec.idle_pct()
