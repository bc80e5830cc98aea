"""Image helpers of the port: quality metrics and the synthetic test image."""
