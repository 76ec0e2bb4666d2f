"""Share of the traced stretch inside the server's entry points the
simulator calls (ingest with its aggregation, dispatch; not the upload's
encode, which is the client's), host clock (%)."""


def read(rec):
    return 100.0 * rec.host_s("bench.server.") / rec.seconds
