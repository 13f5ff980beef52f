"""Mean time a write waits for its sub-writes, from
``waiting_for_subops`` to ``committed``: Σ ``subop_wait_s`` over Σ
``committed`` of every ``osd.*.rmw`` set, in ms."""


def read(r):
    committed = r.counter_sum("osd.", ".rmw", "committed")
    if not committed:
        return None
    return r.counter_sum("osd.", ".rmw", "subop_wait_s") * 1e3 / committed
