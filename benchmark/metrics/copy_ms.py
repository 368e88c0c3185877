"""``copy_ms.<cell kind>``: device time of host-device copies a batch, in
ms (the traced requests' ``gpu_memcpy`` records)."""


def read(view):
    if view is None or not view.batches or not view.trace.count("gpu_memcpy"):
        return None
    return view.trace.device_s("gpu_memcpy") / view.batches * 1e3
