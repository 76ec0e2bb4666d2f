"""Share of the traced stretch in which no kernel, copy or fill ran on the
device (%)."""


def read(rec):
    busy = sum(b - a for a, b in rec.busy_intervals()) / 1e9
    return 100.0 * (1.0 - busy / rec.seconds)
