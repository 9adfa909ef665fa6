"""``peak_mem_gib.train``: ``torch.cuda.max_memory_allocated()`` over the
traced epoch, after ``reset_peak_memory_stats()`` at its start, in GiB."""


def read(run):
    if run.summary is None or run.peak_bytes <= 0:
        return None
    return run.peak_bytes / 2 ** 30
