"""GiB: ``torch.cuda.max_memory_allocated`` over the measured window, after
``reset_peak_memory_stats`` at its start (the caching allocator's counter)."""


def read(obs):
    return obs.window_peak_bytes / 2 ** 30 if obs.window_peak_bytes else None
