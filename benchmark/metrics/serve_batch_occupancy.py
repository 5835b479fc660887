"""serve_batch_occupancy (req/batch): real requests per dispatched batch
over the window, from the `DynamicBatcher`'s own counters
(`BatcherMetrics.batches`, `batched_requests`) read before and after."""


def read(spec, out):
    c = out["counts"]
    if not c["batches"]:
        return None
    return c["batched_requests"] / c["batches"]
