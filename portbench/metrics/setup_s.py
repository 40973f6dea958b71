"""Process start to the first timed submit: imports, data, the kernel
library's load (or build), ingest and the warm-up of the cell's runs."""


def read(rec):
    return rec.setup_s
