"""Count Sketch kernels: CUDA for Hopper, plain PyTorch twins, dispatch."""
