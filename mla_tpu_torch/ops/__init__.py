"""Front-end (torch ops and the fused CUDA kernel), attention pooling, kernel build."""
