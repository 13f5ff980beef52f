"""Process start to the window's start: CUDA init, library load from
the build cache, payloads, cluster boot, prefill, fault injection and
re-peering, and the warm-up."""


def read(r):
    return r.setup_s
