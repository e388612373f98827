"""The port's configuration against the JAX package's: its YAML-subset reader
against PyYAML on every shipped config, and the derived geometry."""
import glob
import os

import pytest
import yaml

from deep3dpointclouddenoising_tpu.config import load_config as jax_load
from deep3dpointclouddenoising_torch.config import (load_config, parse_yaml,
                                                    merge_config,
                                                    default_config)

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cfgs")
ALL_CFGS = sorted(glob.glob(os.path.join(CFG_DIR, "*.yaml"))
                  + glob.glob(os.path.join(CFG_DIR, "custom_cfgs", "*.yaml")))


def _typed(tree):
    """Values with their types, so that 1 != 1.0 != True."""
    if isinstance(tree, dict):
        return {k: _typed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_typed(v) for v in tree]
    return (type(tree).__name__, tree)


@pytest.mark.parametrize("path", ALL_CFGS,
                         ids=lambda p: os.path.relpath(p, CFG_DIR))
def test_yaml_reader_matches_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert _typed(parse_yaml(text)) == _typed(yaml.safe_load(text))


def test_yaml_reader_scalars_and_structure():
    text = ("a: 1  # comment\n# whole line\nb: 1.0e-05\nc: 1e-5\nd: ''\n"
            "e: [1, 0.5, x]\nf:\n- 2\n- katz_1\ng:\n  h: false\n  i: 0.3\n"
            "j: []\nk: yes\nl: ~\nm: 'a # b'\n")
    assert _typed(parse_yaml(text)) == _typed(yaml.safe_load(text))
    with pytest.raises(ValueError):
        parse_yaml("a:\n  b:\n    c: 1\n")


@pytest.mark.parametrize("name", ["l1.yaml", "synthetic_quality.yaml",
                                  "chamfer_5e3.yaml", "outlier_seg_edf.yaml"])
def test_derived_config_matches_jax(name):
    path = os.path.join(CFG_DIR, name)
    assert load_config(path).to_dict() == jax_load(path).to_dict()


def test_l1_geometry():
    cfg = load_config(os.path.join(CFG_DIR, "l1.yaml"))
    assert cfg.radius == 0.025
    assert cfg.sampleDl == 0.0015625
    assert cfg.nsamples == [52, 39, 32, 26, 26]
    assert cfg.npoints == [125, 31, 15, 3]
    assert (cfg.width, cfg.depth, cfg.batch_size) == (144, 2, 16)


def test_unknown_key_rejected(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("not_a_real_key: 1\n")
    with pytest.raises(ValueError):
        load_config(str(bad))
    cfg = merge_config(default_config(), {"pseudo_grid": {"KP_extent": 2.0}})
    assert cfg.pseudo_grid.KP_extent == 2.0
    assert cfg.pseudo_grid.num_kernel_points == 15
