"""Share of the traced stretch inside the uploads' encode (the client's
``encode_update``: the pack and the wire chunks), host clock (%)."""


def read(rec):
    return 100.0 * rec.host_s("bench.encode") / rec.seconds
