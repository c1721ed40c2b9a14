"""The plain PyTorch reference of a frame window, which imports nothing of
the program: the benchmark holds the program's timed path to it."""
