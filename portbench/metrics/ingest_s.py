"""Seconds of ``OMSPipeline.__init__`` (the library encoded, blocked and
uploaded), on the harness's clock, ended by a synchronise."""


def read(rec):
    return rec.ingest_s
