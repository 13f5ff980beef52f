"""1 - (union of the kernel, memcpy and memset intervals) / window, from
torch.profiler over the traced window."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 1.0 - r.trace.busy_s / r.trace.window_s
