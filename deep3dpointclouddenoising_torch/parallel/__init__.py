"""Parallelism over a ``torch.distributed`` group, one process per card
under ``torchrun``: data parallelism, the batch split over the processes
and the parameters replicated (``dist.py``), and spatial parallelism, one
cloud's point axis split over them (``spatial.py``)."""
