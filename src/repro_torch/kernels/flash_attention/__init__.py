"""Forward flash attention (GQA, end-aligned causal mask) as a CUDA
kernel for sm_90a, with its plain PyTorch version."""
