"""Front-end (torch ops and the fused CUDA kernel), the row-merge probe kernels,
attention pooling, kernel build."""
