"""Training: LR schedules, the optimizer chain, the Trainer and the
``python -m deep3dpointclouddenoising_torch.train`` entry point."""
