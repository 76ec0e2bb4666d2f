"""Share of the device time spent in work launched by the SSD scan's plain
backward (the program's ``ssd_chunked_backward`` range) (%)."""


def read(rec):
    acts = rec.launched_in("ssd_chunked_backward")
    if not acts:
        return None
    return 100.0 * rec.device_s(acts) / rec.device_s()
