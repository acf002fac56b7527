"""VMSP support joins: the frontier (P×K) join and the per-prefix s-step
join, as CUDA kernels for sm_90a with plain PyTorch versions."""
