"""The card memory the deployment needs: the allocator's peak
(``torch.cuda.max_memory_allocated``) from the ingest to the end of the
window, in GiB."""


def read(rec):
    if rec.memory_peak_bytes is None:
        return None
    return rec.memory_peak_bytes / 2**30
