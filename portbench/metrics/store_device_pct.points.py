"""The flat-state store's share of the update's device time, in %: the
device time of ``Material._store``'s ``torch.cat`` (its kernels,
``CatArrayBatchedCopy``, which nothing else in an increment launches) over
the device time of what the update calls launched (from the first to the
last device operation of each call, Kineto's GPU annotation of the
harness's ``update`` span around ``Material.integrate``)."""

CAT = "CatArrayBatchedCopy"


def read(rec):
    t = rec.traced.trace if rec.traced else None
    busy = t.device_clipped.get("update") if t else None
    if not busy:
        return None
    return 100.0 * sum(s for op, s in t.ops.items() if CAT in op) / busy
