"""Data and model parallelism over torch.distributed (``mesh``)."""
