"""The most device memory the program held during the window (GiB), the
allocator's peak."""


def read(rec):
    return rec.peak_bytes / 2 ** 30
