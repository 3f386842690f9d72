"""``peak_mem_GiB`` (GiB): ``torch.cuda.max_memory_allocated()`` over the
measured window (the statistic is reset once set-up ends): the operator's
store, the solver's bases and graph pools, everything the solves hold.
Set-up's own peak (slicing's temporaries) is in the result's
``memory_peak_bytes``.  None off the card."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
