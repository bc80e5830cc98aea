"""Image helpers of the port: quality metrics, the synthetic test image,
and the paper's Fig-5 FFT -> IFFT reconstruction."""
