"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their build."""
