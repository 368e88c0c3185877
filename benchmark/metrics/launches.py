"""``launches.<cell kind>``: device kernel launches a batch, every kernel
record of the traced requests (those of K1-K5 match the program's own
launch counters, or the traced run fails)."""


def read(view):
    if view is None or not view.batches:
        return None
    n = view.trace.count("kernel")
    return n / view.batches if n else None
