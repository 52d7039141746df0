"""The card's peak allocated memory over the fit's window, in GB
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start)."""


def read(trace):
    peak = trace.info.get("window_peak_bytes")
    if trace.info.get("kind") != "fit" or peak is None:
        return None
    return peak / 1e9
