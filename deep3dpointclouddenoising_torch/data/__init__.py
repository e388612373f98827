"""Host-side data pipeline for the test split: mesh IO, noise and offset
synthesis, covering patches, batching."""
