"""The device memory's peak over set-up and the measured window
(torch.cuda.max_memory_allocated), GiB."""


def read(rec):
    return rec.peak_bytes / 2**30
