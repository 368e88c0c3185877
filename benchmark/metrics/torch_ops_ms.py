"""``torch_ops_ms.<cell kind>``: device time a batch, in ms, of the
kernels of no family K1-K5: plain torch operations between the port's
kernels."""


def read(view):
    if view is None or not view.batches or not view.trace.count("kernel"):
        return None
    return view.trace.device_s("kernel", others=True) / view.batches * 1e3
