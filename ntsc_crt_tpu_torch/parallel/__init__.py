"""Frame slots split over CUDA cards."""
