"""Process start to the first measured window: imports, the frame, its
index, the injection, the kernel's build or load, the warm-up windows."""


def read(rec):
    return rec.setup_s
