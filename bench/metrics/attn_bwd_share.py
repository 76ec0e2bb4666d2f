"""Share of the device time spent in work launched by flash attention's
plain backward (the program's ``flash_attention_backward`` range) (%)."""


def read(rec):
    acts = rec.launched_in("flash_attention_backward")
    if not acts:
        return None
    return 100.0 * rec.device_s(acts) / rec.device_s()
