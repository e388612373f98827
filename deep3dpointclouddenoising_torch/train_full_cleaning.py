"""Full-cleaning training on one card: joint offset regression and outlier
detection.

Counterpart of ``scripts/train_full_cleaning.py``: the four-output model
(three tanh offsets, one sigmoid outlierness), trained with
``loss = offset loss + outlier loss * in_radius`` by the config's
``L1_classification``, ``Weighted_L1_classification`` or
``double_weight``; the dataset adds ``outlier_percentage`` box outliers.
It shares the train entry point's flags, epoch loop and checkpoints::

    python -m deep3dpointclouddenoising_torch.train_full_cleaning \\
        --config_file cfgs/synthetic_quality_cleaning.yaml --data_root D \\
        --log_dir L [--num_steps S] [--epochs E] [--device cuda] \\
        [--auto_resume] [--load_path P] [--load_weights_path W]

``infer --full_cleaning --checkpoint L/<experiment>/current.pt`` reads the
checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .train import __main__ as _train_cli


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train; returns the train entry point's summary."""
    return _train_cli.main(argv, loss_mode="full_cleaning")


if __name__ == "__main__":
    main()
