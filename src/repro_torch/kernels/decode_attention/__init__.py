"""Single-token decode attention over a KV cache (flash-decoding) as a
CUDA kernel for sm_90a, with its plain PyTorch version."""
