"""Data parallelism: one process per card under ``torchrun``, the batch
split over the processes, the parameters replicated (``dist.py``)."""
