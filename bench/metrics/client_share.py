"""Share of the traced stretch inside the clients' ``local_train`` calls,
host clock (%): the LM's forward, backward and SGD steps of the uploads."""


def read(rec):
    return 100.0 * rec.host_s("bench.client.") / rec.seconds
