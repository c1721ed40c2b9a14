"""Device operations of the port: four-vectors, the counter RNG and the
fused transport round (plain PyTorch twin + CUDA kernel wrapper)."""
