"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats(), in GiB."""


def read(run):
    peak = run.get("peak_window_bytes")
    return None if peak is None else peak / 2**30
