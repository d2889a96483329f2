"""Peak device memory allocated in the window (torch.cuda.max_memory_allocated
after reset_peak_memory_stats at its start), GiB."""


def read(res):
    if res["trace"] is not None:
        return None
    return res["window"].peak_bytes / 2 ** 30
