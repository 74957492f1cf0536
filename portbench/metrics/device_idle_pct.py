"""device_idle_pct.<cell family>: the share of the traced stretch in which
no kernel, copy or fill runs on the card, in %.  One reader for every
name that starts ``device_idle_pct.``."""


def read(ctx):
    if ctx["trace_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])
